"""Batched serving: what ``python -m msd_tpu_torch.reconstruct --batch N``
does for each batch of a test split, back to back.

Set-up makes the decoder's weights on the device from the seed and fits
them to a family of ellipsoids (``inputs.fit_family_decoder``), loads them
into the program's decoder, makes the held-out shapes (a fixed set of
ellipsoids, the same for every seed, sampled anew from the seed), builds
one ``PointEvaluator`` and warms its stream at the cell's resolution, and
runs one short fit and one mesh of the cell's shapes. A batch fits N
shapes at once (``reconstruct_batch``, float32), then meshes each with a
streamed ``create_mesh`` that writes its PLY, and saves each latent, as the
CLI does; the files are deleted as the run goes. The window runs whole
batches until the time has passed.

The comparison, on shapes of every batch the window served, at slots
drawn from the seed (``_sample``): the reference fits each again from the same inputs and draws in
float32 (``reference/serve.py``). Compared are the first iteration's loss
(the start of the fit, which the reference follows exactly), the loss of
the program's fitted latent against the reference's on a fixed set of the
shape's samples (the end of the fit; latents themselves drift by Adam's
step size between any two float32 runs), the crossing of each sampled
axis-edge vertex of the program's mesh against the crossing of the
reference's float32 values at that edge's ends (K1's values and the
mesher), and the count of axis edges with a sign change in lattice planes
drawn from the seed (the mesh's extent).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench.run import PhaseClock

from portbench import inputs
from portbench.reference import serve as ref


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.specs = ctx.config["specs"]
        self.t = ctx.workload["traffic"]
        self.dev = ctx.device
        self.served = []  # per batch: dict(order, seed, first, latents, verts)
        self.fit_s = self.mesh_s = self.mesher_s = 0.0
        self.failed = 0
        self._ref_fit = None

    def setup(self):
        from msd_tpu_torch import mesh
        from msd_tpu_torch.models import build_decoder
        from msd_tpu_torch.ops import fused_mlp

        specs, t = self.specs, self.t
        self.mesh_mod = mesh
        clock = PhaseClock(self.ctx.name)
        gen = torch.Generator(device=self.dev).manual_seed(self.ctx.seed)
        params = inputs.init_weights(specs, gen, self.dev)
        self.params = inputs.fit_family_decoder(specs, params, gen, int(t["family"]), int(t["family_steps"]),
                                                int(t["family_points"]), float(t["family_lr"]))
        clock.mark("weights")
        dec = build_decoder(specs["NetworkArch"], int(specs["CodeLength"]), specs["NetworkSpecs"])
        dec.load_state_dict({k: v.cpu() for k, v in self.params.items()})
        self.decoder = dec.to(self.dev).eval()
        n = int(t["shapes_per_batch"])
        axes = torch.as_tensor(inputs.fixed_axes(n, int(t["axes_seed"])), device=self.dev)
        self.pool = []
        for _ in range(int(t["sample_sets"])):
            pos, pc, neg, nc, _ = inputs.scene_samples(n, int(t["rows_per_shape"]), gen, self.dev, axes=axes)
            pos_h, neg_h, pc_h, nc_h = pos.cpu().numpy(), neg.cpu().numpy(), pc.tolist(), nc.tolist()
            self.pool.append([(pos_h[i, :pc_h[i]], neg_h[i, :nc_h[i]]) for i in range(n)])
        clock.mark("shapes")
        self.rng = np.random.default_rng(self.ctx.seed)
        self.fit_seed = (self.ctx.seed * 7919) % 2**40
        self.N = int(t["mesh_resolution"])
        self.evaluator = mesh.PointEvaluator(self.decoder)
        if mesh._streams(self.evaluator):
            self.evaluator.warm_stream(mesh._snap_n(self.N))
        clock.mark("evaluator")
        self.out_dir = tempfile.mkdtemp(prefix="portbench_serve_")
        _, latents = self._fit(self.pool[0], self.fit_seed, int(t["warm_iterations"]))
        clock.mark("warm_fit")
        self._mesh(latents[0], "warm")
        clock.mark("warm_mesh")
        clock.report()
        self.k1_launches0 = fused_mlp.LAUNCHES
        self.evaluated0 = self.evaluator.n_evaluated
        self.fit_s = self.mesh_s = self.mesher_s = 0.0

    def _fit(self, shapes, seed, iterations):
        from msd_tpu_torch.train.reconstruct import reconstruct_batch

        t = self.t
        return reconstruct_batch(self.decoder, iterations, int(self.specs["CodeLength"]), shapes, float(t["init_std"]),
                                 float(t["clamp"]), num_samples=int(t["samples"]), lr=float(t["lr"]),
                                 l2reg=bool(t["l2reg"]), return_loss_hist=True, seed=seed)

    def _mesh(self, latent, name):
        """Mesh ``latent`` as the CLI does (PLY and latent written, then
        deleted here); returns the vertices or None."""
        t0 = time.perf_counter()
        base = os.path.join(self.out_dir, name)
        with self.ctx.tracer.span("mesh"):
            res = self.mesh_mod.create_mesh(self.decoder, latent, base, N=self.N, max_batch=int(self.t["max_batch"]),
                                            return_mesh=True, evaluator=self.evaluator)
            torch.save(latent.detach().cpu().reshape(1, -1)[None, ...].clone(), base + ".pth")
        self.mesh_s += time.perf_counter() - t0
        self.mesher_s += float(self.mesh_mod.LAST_STREAMING_STATS.get("t_mesher", 0.0))
        for ext in (".ply", ".pth"):
            if os.path.exists(base + ext):
                os.remove(base + ext)
        return res[0] if res else None

    def unit(self):
        k = len(self.served)
        shapes_set = self.pool[k % len(self.pool)]
        order = self.rng.permutation(len(shapes_set))
        seed = self.fit_seed + 1 + k * len(order)
        t0 = time.perf_counter()
        with self.ctx.tracer.span("fit"):
            hist, latents = self._fit([shapes_set[i] for i in order], seed, int(self.t["iterations"]))
        self.fit_s += time.perf_counter() - t0
        verts = []
        for j in range(len(order)):
            v = self._mesh(latents[j], f"b{k}_s{j}")
            self.failed += v is None
            verts.append(v)
        self.served.append({"set": k % len(self.pool), "order": order, "seed": seed, "first": hist[:, 0].copy(),
                            "latents": latents.detach().clone(), "verts": verts})

    def shapes(self) -> int:
        return sum(len(b["order"]) for b in self.served)

    def end_to_end(self, window_s: float) -> dict:
        return {"serve_shapes_per_s": self.shapes() / window_s}

    def outcome(self):
        return self.shapes(), self.failed

    def readings(self) -> dict:
        from msd_tpu_torch.ops import fused_mlp

        n = self.shapes()
        return {"kind": "serve", "shapes": n, "fit_s": self.fit_s, "mesh_s": self.mesh_s, "mesher_s": self.mesher_s,
                "fit_points": n * int(self.t["iterations"]) * int(self.t["samples"]),
                "k1_points": self.evaluator.n_evaluated - self.evaluated0,
                "k1_launches": fused_mlp.LAUNCHES - self.k1_launches0}

    def release(self):
        self.decoder = self.evaluator = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.out_dir, ignore_errors=True)

    # --- the comparison ------------------------------------------------
    def _sample(self):
        """(batch, slot) of the shapes compared: ``check_per_batch`` from
        every batch, at slots taken in turn from an order of the slots
        drawn from the seed, so that every slot is compared once the
        window holds ``shapes_per_batch / check_per_batch`` batches."""
        n, per = int(self.t["shapes_per_batch"]), int(self.t["check_per_batch"])
        slots = np.random.default_rng([self.ctx.seed, 1]).permutation(n)
        return [(b, int(slots[(b * per + i) % n])) for b in range(len(self.served)) for i in range(min(per, n))]

    def _shape(self, b, j):
        rec = self.served[b]
        pos, neg = self.pool[rec["set"]][rec["order"][j]]
        return torch.as_tensor(pos, device=self.dev), torch.as_tensor(neg, device=self.dev)

    def numbers(self, fit: str = "program", values: str = "program") -> dict:
        """The compared numbers. ``fit`` and ``values`` say what stands in
        the program's place: ``"program"`` (its own outputs), a precision
        mode of the reference (the control: ``"tf32"`` for the float32 fit,
        ``"fp8"`` for K1's bf16 values), or, for the fit, a planted fault
        (``"unchanged"``: the latents never leave their start;
        ``"half_batch"``: each iteration's loss over half its rows)."""
        t, cfg = self.t, self.specs
        clamp, L = float(t["clamp"]), int(cfg["CodeLength"])
        rng = np.random.default_rng([self.ctx.seed, 2])
        picks = self._sample()
        shapes = [self._shape(b, j) for b, j in picks]
        seeds = [self.served[b]["seed"] + j for b, j in picks]
        fit_args = (cfg, self.params, shapes, seeds, int(t["iterations"]), int(t["samples"]), float(t["lr"]),
                    bool(t["l2reg"]), clamp, float(t["init_std"]))
        if self._ref_fit is None:
            self._ref_fit = ref.fit(*fit_args, mode="float32")
        ref_first, ref_z = self._ref_fit
        if fit == "program":
            first = np.array([self.served[b]["first"][j] for b, j in picks])
            z = torch.stack([self.served[b]["latents"][j] for b, j in picks]).to(self.dev)
        elif fit == "unchanged":
            first, z = ref_first.cpu().numpy(), ref.initial_latents(cfg, seeds, float(t["init_std"]), self.dev)
        elif fit == "half_batch":
            first, _ = ref.fit(*fit_args[:4], 1, *fit_args[5:], half_batch=True)
            first, z = first.cpu().numpy(), ref_z
        else:
            first, z = ref.fit(*fit_args, mode=fit)
            first = first.cpu().numpy()
        first_gap = float(np.max(np.abs(first - ref_first.cpu().numpy()) / np.abs(ref_first.cpu().numpy())))
        excess, t_gap, count_gap = [], [], []
        gen = torch.Generator(device=self.dev).manual_seed(int(rng.integers(2**62)))
        N = self.mesh_mod._snap_n(self.N)
        for i, (pos, neg) in enumerate(shapes):
            m = int(t["eval_samples"]) // 2
            rows = torch.cat([pos[torch.randint(0, len(pos), (m,), generator=gen, device=self.dev)],
                              neg[torch.randint(0, len(neg), (m,), generator=gen, device=self.dev)]])[None]
            with ref.ref_decoder.precision("float32"):
                lp, lr_ = (float(ref.shape_loss(cfg, self.params, x.reshape(1, 1, L), rows, clamp, bool(t["l2reg"])))
                           for x in (z[i], ref_z[i]))
            excess.append((lp - lr_) / lr_)
            b, j = picks[i]
            verts = self.served[b]["verts"][j]
            if verts is None:  # no mesh: counted as failed, and nothing to compare
                t_gap.append(float("inf"))
                count_gap.append(float("inf"))
                continue
            latent = self.served[b]["latents"][j].to(self.dev)
            lo, axis, tp = ref.axis_edge_vertices(verts, N)
            sel = rng.choice(len(lo), size=min(int(t["check_vertices"]), len(lo)), replace=False)
            t_ref = ref.edge_t(cfg, self.params, latent, lo[sel], axis[sel], N, "float32")
            if values == "program":
                t_cmp = torch.as_tensor(tp[sel], device=self.dev, dtype=t_ref.dtype)
            else:
                t_cmp = ref.edge_t(cfg, self.params, latent, lo[sel], axis[sel], N, values)
            t_gap.append(float((t_cmp - t_ref).abs().mean()))
            zs = np.unique(lo[:, 2])
            planes = rng.choice(zs, size=min(int(t["check_planes"]), len(zs)), replace=False)
            n_ref = ref.plane_crossings(cfg, self.params, latent, N, planes, "float32")
            if values == "program":
                n_cmp = ref.mesh_plane_crossings(lo, axis, planes)
            else:
                n_cmp = ref.plane_crossings(cfg, self.params, latent, N, planes, values)
            count_gap.append(abs(n_cmp - n_ref) / n_ref)
        return {"fit_first_loss_gap": first_gap, "fit_excess_loss": max(excess),
                "mesh_edge_t_gap": max(t_gap), "mesh_edge_count_gap": max(count_gap)}

    def program(self) -> dict:
        """Every number the comparison reads, for the program."""
        return self.numbers()

    def check(self) -> dict:
        nums = self.program()
        return {k: {"value": nums[k], "limit": v} for k, v in self.ctx.workload["limits"].items()}

    def control(self) -> dict:
        return self.numbers(fit="tf32", values="fp8")

    def faults(self) -> dict:
        return {f: self.numbers(fit=f) for f in ("unchanged", "half_batch")}
