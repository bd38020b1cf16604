"""Stage-1 training: ``Stage1Trainer.train_epoch`` back to back.

Set-up makes the scenes on the device from the seed (``inputs.scene_samples``)
and hands them to the trainer as its dataset, loads the benchmark's own
initial weights and latents into it, and runs the first epoch through
``train_epoch``, the window's own call: that builds K2 and warms every
shape. The window runs whole epochs until the time has passed;
each ends at the epoch's own fetch of its metrics. The post-epoch work of
``train()`` (TensorBoard, snapshots, eval hooks) stays out, as in a closed
loop of epochs.

The comparison follows two stretches of three steps with a plain reference
(``reference/stage1.py``) in float32: the first three steps of set-up's
epoch, from the benchmark's inputs, and the first three of the window's
first epoch, from the trainer's state as the window opened (its leaves,
Adam's moments and step count, copied before the window's clock starts).
For each stretch: each step's loss; the first gradient as the optimizer
took it (from Adam's first moment before and after that step); and each
leaf's change after three steps. The gradient and the change are compared
leaf by leaf against the larger of the reference leaf's norm and the median
leaf's, both as the gap of the norms and as the norm of the difference;
leaves whose reference gradient is under a thousandth of the median leaf's
are left out. The window's numbers carry the prefix ``window_``.
"""

from __future__ import annotations

import copy
import shutil
import tempfile

import numpy as np
import torch

from portbench.run import PhaseClock

from portbench import inputs
from portbench.reference import stage1 as ref

# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone and are left out
ZERO_GRAD_SHARE = 1e-3


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def worst_leaf(prog: dict, refv: dict, keep, of_difference: bool) -> float:
    """Worst leaf's |‖p‖ - ‖r‖| (or ‖p - r‖ with ``of_difference``) over
    max(‖r‖, median leaf's ‖r‖)."""
    rn = {k: _norm(refv[k]) for k in keep}
    med = float(np.median(list(rn.values())))
    if of_difference:
        gaps = {k: _norm(prog[k].to(refv[k].dtype) - refv[k]) for k in keep}
    else:
        gaps = {k: abs(_norm(prog[k]) - rn[k]) for k in keep}
    return max(gaps[k] / max(rn[k], med) for k in keep)


def _clone(groups: dict) -> dict:
    return {g: {k: v.detach().clone() for k, v in xs.items()} for g, xs in groups.items()}


def _flat(groups: dict) -> dict:
    return {f"{g}/{k}": v for g, xs in groups.items() for k, v in xs.items()}


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.specs = dict(ctx.config["specs"], Seed=ctx.seed)
        self.traffic = ctx.workload["traffic"]
        self.dev = ctx.device
        self.steps = 0
        self.seen = {}  # stretch -> (losses, first gradient, leaves after 3 steps) of the program
        self._ref_out = {}

    def setup(self):
        from msd_tpu_torch.data.sdf_samples import SdfDataset
        from msd_tpu_torch.ops import fused_train
        from msd_tpu_torch.train.stage1 import Stage1Trainer

        specs, t = self.specs, self.traffic
        if specs.get("UseGMMPriorLoss"):
            raise NotImplementedError("the reference does not follow the GMM latent prior")
        clock = PhaseClock(self.ctx.name)
        gen = torch.Generator(device=self.dev).manual_seed(self.ctx.seed)
        S = int(t["scenes"])
        pos, pc, neg, nc, _ = inputs.scene_samples(S, int(t["rows_per_scene"]), gen, self.dev)
        clock.mark("scenes")
        self.data = (inputs.soa(pos), pc.long(), inputs.soa(neg), nc.long())
        del pos, neg
        names = [f"scene{i}" for i in range(S)]
        empty = np.zeros((S, 0, 4), np.float32)
        dataset = SdfDataset(names, names, empty, pc.cpu().numpy().astype(np.int32), empty,
                             nc.cpu().numpy().astype(np.int32), int(specs["SamplesPerScene"]))
        dataset._device[str(torch.device(self.dev))] = self.data
        params0 = inputs.init_weights(specs, gen, self.dev)
        latents0 = inputs.init_latents(S, int(specs["CodeLength"]), float(specs.get("CodeInitStdDev", 1.0)),
                                       gen, self.dev)
        self.exp_dir = tempfile.mkdtemp(prefix="portbench_stage1_")
        tr = Stage1Trainer(self.exp_dir, specs=specs, dataset=dataset, device=self.dev)
        tr.decoder.load_state_dict(params0)
        with torch.no_grad():
            tr.latents.copy_(latents0)
        self.trainer = tr
        clock.mark("trainer")
        self.B, self.P = int(specs["ScenesPerBatch"]), int(specs["SamplesPerScene"])
        if S // self.B < 3:
            raise ValueError(f"{S} scenes make {S // self.B} steps an epoch; the comparison follows 3")
        self.rng = np.random.default_rng(self.ctx.seed)
        # where each stretch starts: the reference's inputs, the scene order,
        # the step count, the epoch, Adam's moments (None: zero)
        self.starts = {"start": self._start({"net": params0, "lat": {"weight": latents0}}, None, 1)}
        self.epoch = 1
        self._probe("start")
        tr.train_epoch(self.epoch, rng=self.rng)
        self.epoch += 1
        opt = tr.optimizer
        self.starts["window"] = self._start(_clone(opt.groups), (_clone(opt.mu), _clone(opt.nu), opt.count),
                                            self.epoch)
        self._probe("window")
        self.launches0 = dict(fused_train.KERNEL_LAUNCHES)
        self.log0 = len(tr.loss_log)
        clock.mark("first_epoch")
        clock.report()

    def _start(self, groups, moments, epoch):
        return {"groups": groups, "moments": moments, "epoch": epoch, "step0": self.trainer.global_batch_idx,
                "perm": copy.deepcopy(self.rng).permutation(self.trainer.num_scenes),
                "log0": len(self.trainer.loss_log)}

    def _probe(self, stretch: str):
        """Record the first gradient the optimizer takes from here on and
        its leaves three steps later; then take the probe away."""
        opt = self.trainer.optimizer
        step, count0, got = type(opt).step.__get__(opt), opt.count, {}

        def probed(lrs, max_norm=None, clip_groups=("net",)):
            m0 = _clone(opt.mu) if opt.count == count0 else None
            out = step(lrs, max_norm=max_norm, clip_groups=clip_groups)
            if m0 is not None:
                got["grad1"] = {f"{g}/{k}": (m - opt.b1 * m0[g][k]) / (1.0 - opt.b1)
                                for g, ms in opt.mu.items() for k, m in ms.items()}
            if opt.count == count0 + 3:
                got["params3"] = _flat(_clone(opt.groups))
                self.seen[stretch] = got
                del opt.step
            return out

        opt.step = probed

    def unit(self):
        with self.ctx.tracer.span("epoch"):
            self.trainer.train_epoch(self.epoch, rng=self.rng)
        self.epoch += 1
        self.steps += self.trainer.num_scenes // self.B

    def end_to_end(self, window_s: float) -> dict:
        return {"train_samples_per_s": self.steps * self.B * self.P / window_s}

    def outcome(self):
        losses = np.asarray(self.trainer.loss_log[self.log0:], np.float64)
        return len(losses), int((~np.isfinite(losses)).sum())

    def readings(self) -> dict:
        from msd_tpu_torch.ops import fused_train

        return {"kind": "train", "steps": self.steps, "samples": self.steps * self.B * self.P,
                "scenes_per_step": self.B, "points_per_scene": self.P,
                "k2_kernels": {k: fused_train.KERNEL_LAUNCHES[k] - self.launches0.get(k, 0)
                               for k in fused_train.KERNEL_LAUNCHES}}

    def release(self):
        for stretch, st in self.starts.items():
            self.seen[stretch]["losses"] = list(self.trainer.loss_log[st["log0"]:st["log0"] + 3])
        self.trainer = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.exp_dir, ignore_errors=True)

    def reference(self, stretch: str, mode: str = "float32", half_batch: bool = False):
        """(losses of the stretch's 3 steps, first gradient, leaves after
        them) of the reference in ``mode`` from the stretch's start;
        ``half_batch`` plants that fault in it."""
        st = self.starts[stretch]
        g = st["groups"]
        r = ref.Stage1Reference(self.specs, g["net"], g["lat"]["weight"], mode=mode,
                                half_batch=half_batch, moments=st["moments"])
        losses, grad1, params3 = [], None, None
        for k in range(1, 4):
            idx = torch.as_tensor(st["perm"][(k - 1) * self.B:k * self.B], device=self.dev)
            gen = torch.Generator(device=self.dev).manual_seed(ref.step_seed(self.ctx.seed, st["step0"] + k))
            batch = ref.sample_batch(*self.data, idx, self.P, gen)
            loss, taken = r.step(idx, batch, epoch=st["epoch"])
            losses.append(loss)
            if k == 1:
                grad1 = {f"{gr}/{n}": x.clone() for gr, xs in taken.items() for n, x in xs.items()}
        params3 = {name: v.clone() for name, v in r.leaves().items()}
        return losses, grad1, params3

    def numbers(self, stretch: str, losses, grad1, params3) -> dict:
        """The compared numbers of one stretch, for (losses, first
        gradient, leaves after 3 steps) in the program's place."""
        r_losses, r_grad1, r_params3 = self._ref(stretch)
        start = _flat(self.starts[stretch]["groups"])
        gn = {k: _norm(v) for k, v in r_grad1.items()}
        med = float(np.median(list(gn.values())))
        if med == 0.0:
            raise RuntimeError("the reference's first gradient is zero: the inputs leave nothing to train")
        keep = sorted(k for k, v in gn.items() if v >= ZERO_GRAD_SHARE * med)
        d_prog = {k: params3[k] - start[k] for k in keep}
        d_ref = {k: r_params3[k] - start[k] for k in keep}
        pre = "" if stretch == "start" else stretch + "_"
        return {
            pre + "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
            pre + "grad_gap": worst_leaf(grad1, r_grad1, keep, False),
            pre + "change_gap": worst_leaf(d_prog, d_ref, keep, False),
            pre + "grad_diff": worst_leaf(grad1, r_grad1, keep, True),
            pre + "change_diff": worst_leaf(d_prog, d_ref, keep, True),
        }

    def _both(self, outputs) -> dict:
        out = {}
        for stretch in self.starts:
            out.update(self.numbers(stretch, *outputs(stretch)))
        return out

    def program(self) -> dict:
        """Every number the comparison reads, for the program."""
        return self._both(lambda s: (self.seen[s]["losses"], self.seen[s]["grad1"], self.seen[s]["params3"]))

    def check(self) -> dict:
        nums = self.program()
        return {k: {"value": nums[k], "limit": v} for k, v in self.ctx.workload["limits"].items()}

    def control(self) -> dict:
        """The numbers of the reference in fp8 put in the program's place."""
        return self._both(lambda s: self.reference(s, "fp8"))

    def faults(self) -> dict:
        """The numbers of the reference with half of each batch left out,
        put in the program's place. (A state left unchanged reads 1 in the
        gaps of norms and in the change's difference, with no run.)"""
        return {"half_batch": self._both(lambda s: self.reference(s, "float32", half_batch=True))}

    def _ref(self, stretch: str):
        if stretch not in self._ref_out:
            self._ref_out[stretch] = self.reference(stretch)
        return self._ref_out[stretch]
