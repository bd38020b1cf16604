"""msd_tpu_torch — the PyTorch/CUDA port of ``msd_tpu`` for NVIDIA Hopper.

Module names mirror ``msd_tpu`` so each counterpart is easy to find. The
port imports torch, numpy and scipy only; it never imports JAX or
``msd_tpu``. Today it runs the serving path: load a decoder checkpoint,
fit a latent per shape (``train/reconstruct.py``), mesh it
(``mesh.create_mesh``, whose SDF queries go through the hand-written CUDA
kernel in ``csrc/fused_mlp.cu`` on a GPU) and score the mesh
(``eval_chamfer.evaluate``).
"""

__version__ = "0.1.0"
