"""msd_tpu_torch — the PyTorch/CUDA port of ``msd_tpu`` for NVIDIA Hopper.

Module names mirror ``msd_tpu`` so each counterpart is easy to find. The
port imports torch, numpy and scipy, and matplotlib only where it draws
figures (``plotting`` and the figure CLIs); it never imports JAX,
``msd_tpu`` or scikit-learn. It runs the serving path: load a decoder checkpoint, fit a
latent per shape (``train/reconstruct.py``), mesh it (``mesh.create_mesh``,
whose SDF queries go through the hand-written CUDA kernel in
``csrc/fused_mlp.cu`` on a GPU) and score the mesh
(``eval_chamfer.evaluate``). It trains Stage 1 (``train/stage1.py``, the
``train_deep_sdf`` CLI), with the loss and every gradient of a step
computed by the hand-written CUDA kernels in ``csrc/fused_train.cu`` on a
GPU. It prepares training data (``preprocess_data``,
``run_all_preprocessing``, ``utils/*``: NIfTI masks to SdfSamples, the kNN
sign vote on the card). Its tooling draws the figures (``plotting``,
``plot_log``, ``analyze_sdf_npz``), explores the latent space
(``explorer``, ``latent_explorer``, every frame through K1) and embeds the
latents (``manifold``, ``latent_manifold``).
"""

__version__ = "0.1.0"
