"""``ProfileEpochs`` in the port's Stage-1 trainer on the CPU: a listed
epoch's training runs under ``torch.profiler`` and writes one trace to
``<exp>/TensorBoard/profile`` (``msd_tpu``'s directory), an epoch not
listed is not traced, profiling changes no number, over 2 gloo ranks each
rank writes its own file, and a profiler that records no CUDA activity for
a trainer on the card raises. This module imports no JAX: the ranks are
spawned processes that import it again."""

import glob
import json
import os

import pytest
import torch

from msd_tpu_torch.parallel import run_ranks
from msd_tpu_torch.train.stage1 import Stage1Trainer
from test_torch_dp import TIMEOUT, cpus, stage1_experiment


def traces(exp):
    return sorted(glob.glob(os.path.join(exp, "TensorBoard", "profile", "*.pt.trace.json")))


def train(exp, epochs):
    """Train ``epochs`` epochs on the CPU; returns the trainer and, per
    epoch, whether the profiler was on during its ``train_epoch``."""
    tr = Stage1Trainer(exp, device="cpu")
    profiled, inner = [], tr.train_epoch

    def train_epoch(epoch, *args):
        profiled.append(torch.autograd._profiler_enabled())
        return inner(epoch, *args)

    tr.train_epoch = train_epoch
    tr.train(num_epochs=epochs, eval_hooks=False)
    return tr, profiled


def test_profiled_epoch_writes_one_trace(tmp_path):
    """msd_tpu's test_profile_epochs_hook: ``ProfileEpochs`` [1] on a
    1-epoch run writes one trace, a Chrome trace of the epoch's operations,
    named by the rank."""
    exp = stage1_experiment(tmp_path, NumEpochs=1, ProfileEpochs=[1])
    _, profiled = train(exp, 1)
    assert profiled == [True]
    (path,) = traces(exp)
    assert os.path.basename(path).startswith("rank0.")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_profiling_traces_only_listed_epochs_and_changes_no_number(tmp_path):
    """[2] on 3 epochs traces epoch 2 alone; losses, latents, decoder and
    every checkpoint file equal an unprofiled run's bit for bit."""
    plain_exp = stage1_experiment(tmp_path / "plain", NumEpochs=3, SnapshotFrequency=1)
    exp = stage1_experiment(tmp_path / "profiled", NumEpochs=3, SnapshotFrequency=1, ProfileEpochs=[2])
    plain, plain_profiled = train(plain_exp, 3)
    tr, profiled = train(exp, 3)
    assert plain_profiled == [False] * 3 and not traces(plain_exp)
    assert profiled == [False, True, False] and len(traces(exp)) == 1
    assert tr.loss_log == plain.loss_log and tr.loss_log_epoch == plain.loss_log_epoch
    assert torch.equal(tr.latents, plain.latents)
    for (name, a), b in zip(tr.decoder.state_dict().items(), plain.decoder.state_dict().values()):
        assert torch.equal(a, b), name
    for sub in ("ModelParameters", "LatentCodes", "OptimizerParameters"):
        for name in ("1.pth", "2.pth", "3.pth", "latest.pth"):
            ours = torch.load(os.path.join(exp, sub, name), weights_only=False)
            ref = torch.load(os.path.join(plain_exp, sub, name), weights_only=False)
            assert_equal_tree(ours, ref, f"{sub}/{name}")


def assert_equal_tree(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            assert_equal_tree(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_tree(x, y, f"{what}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def profiled_rank(group, exp):
    torch.set_num_threads(2)
    Stage1Trainer(exp, group=group).train(num_epochs=1, eval_hooks=False)


def test_profiled_epoch_over_ranks_writes_a_file_per_rank(tmp_path):
    exp = stage1_experiment(tmp_path, NumEpochs=1, ProfileEpochs=[1])
    run_ranks(profiled_rank, 2, (exp,), devices=cpus(2), timeout=TIMEOUT)
    names = [os.path.basename(p).split(".")[0] for p in traces(exp)]
    assert sorted(names) == ["rank0", "rank1"]
    for path in traces(exp):
        with open(path) as f:
            assert json.load(f)["traceEvents"]


def test_profile_without_device_activity_raises(tmp_path):
    """A trainer on the card whose profiler records no CUDA activity raises
    and writes no trace: here a trainer told it sits on the card, on a host
    where the profiler cannot record CUDA."""
    exp = stage1_experiment(tmp_path, NumEpochs=1, ProfileEpochs=[1])
    tr = Stage1Trainer(exp, device="cpu")
    tr.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        with tr._epoch_profiler():
            torch.ones(3).sum()
    assert not traces(exp)
