"""Shared sizes for the benchmark's CPU tests: the cells' own files with
widths and counts shrunk so that a run takes seconds on the CPU."""

import pytest
import torch

SMALL_NET = {"dims": [128] * 8, "dropout": [], "dropout_prob": 0.2, "norm_layers": [], "latent_in": [4],
             "xyz_in_all": False, "use_tanh": False, "latent_dropout": False, "weight_norm": True}

TRAIN_SMALL = {"config": {"NetworkSpecs": SMALL_NET, "CodeLength": 16, "ScenesPerBatch": 4, "SamplesPerScene": 256},
               "traffic": {"scenes": 12, "rows_per_scene": 6000}}
SERVE_SMALL = {"config": {"NetworkSpecs": SMALL_NET, "CodeLength": 16},
               "traffic": {"shapes_per_batch": 2, "iterations": 400, "samples": 512, "mesh_resolution": 32,
                           "rows_per_shape": 6000, "family": 16, "family_steps": 400, "family_points": 1024,
                           "family_lr": 2e-3,
                           "check_vertices": 500, "eval_samples": 2048}}
SMALL = {"stage1.flagship": TRAIN_SMALL, "serve.flagship-b8": SERVE_SMALL}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
