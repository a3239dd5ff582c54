"""Training traffic: the GAN step over a patch store (a closed loop).

The mix file gives the batch and patch size, the store's patch count
(made from the seed on the device and handed to the program's
`DeviceLoader`), the host sync interval of the trainer's loop, the number
of first steps set-up runs (which the comparison reads), and, for
`--trace 1`, where the traced stretch starts and how many steps it covers.

Set-up builds one training object and drives it through its first steps
with the window's own call and feed; the window continues it. The
comparison follows those first steps with the reference, from the same
seeded weights and interpolation weights, on batches it gathers itself
from the benchmark's store by the loader's epoch rule (`reference_batches`)
and holds against those the loader served (`loader_batch_gap`, exact), and
`compare` reads the generator's output and both losses in the first step,
each parameter's first gradient (the program's read from its Adam state
after one step) and each parameter's change over the first steps. A cell
holds those of them that its limits name.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import counts, program, reference, scenes, weights
from benchmark.reference.critic import GanStep
from benchmark.reference.nn import Arith, no_tf32
from benchmark.trace import Schedule, maybe_span as _maybe


def seeded_states(cell, device) -> tuple:
    with torch.device("meta"):
        g = reference.generator(cell.config, "meta")
        d = reference.critic(cell.config, "meta")
    return (weights.model_state(g, weights.stream(cell.seed, weights.GENERATOR, device), device),
            weights.model_state(d, weights.stream(cell.seed, weights.CRITIC, device), device))


def make_store(cell, device) -> dict:
    t = cell.traffic
    p = t["patch"]
    sc = scenes.scenes(weights.stream(cell.seed, weights.PATCHES, device), t["store_patches"], p, p,
                       device, spp=t["spp"], gt_spp=t["gt_spp"], noise_scale=t["noise_scale"],
                       hdr_scale=t["hdr_scale"])
    return {k: v.cpu().numpy() for k, v in sc.items()}


def norms(tensors: dict) -> dict:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[n].float().norm() for n in names]).tolist()
    return dict(zip(names, vals))


class Snapshot:
    """What the comparison reads of a side's first steps: the losses, the
    norm of each parameter's first gradient and of its change."""

    def __init__(self, models: dict) -> None:
        self.models = models
        self.start = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
                      for k, m in models.items()}
        self.losses, self.grads, self.change, self.g_out = [], {}, {}, None

    def changed(self) -> None:
        for k, m in self.models.items():
            cur = dict(m.named_parameters())
            self.change[k] = norms({n: cur[n].detach() - p0 for n, p0 in self.start[k].items()})
        self.start = None

    def readings(self) -> dict:
        return {"losses": self.losses, "grads": self.grads, "change": self.change,
                "g_out": self.g_out}


def first_grads(model, opt, beta1: float) -> dict:
    """Each parameter's first gradient as the Adam `opt` took it, from its
    state after one step (exp_avg = (1 − β1)·g); absent where it took none."""
    out = {}
    for n, p in model.named_parameters():
        st = opt.state.get(p, {})
        if "exp_avg" in st:
            out[n] = st["exp_avg"] / (1.0 - beta1)
    return norms(out)


def reference_side(cell, batches: list, g_arith: Arith, d_arith: Arith, device,
                   fault: str | None = None) -> dict:
    """The reference's first steps in `g_arith`/`d_arith`. `fault` plants one
    in it: "half_batch" (the first half of each batch alone) or
    "altered_output" (sample 0's generator output replaced by its input)."""
    g_state, d_state = seeded_states(cell, device)
    g = reference.generator(cell.config, device)
    d = reference.critic(cell.config, device)
    g.load_state_dict(g_state)
    d.load_state_dict(d_state)
    if fault == "altered_output":
        forward = g.forward

        def altered(x, aux, arith):
            out = forward(x, aux, arith)
            return torch.cat([x[:1], out[1:]])

        g.forward = altered
    o = cell.config["optimizer"]
    spe = -(-cell.traffic["store_patches"] // cell.traffic["batch"])
    opt = dict(lr_g=o["lr_g"], lr_d=o["lr_d"], betas=o["betas"], eps=o["eps"], gamma=o["gamma"],
               milestone_epochs=milestones(o), steps_per_epoch=spe)
    step = GanStep(g, d, opt, cell.config["losses"], g_arith, d_arith)
    gen = weights.stream(cell.seed, weights.GP_ALPHA, device)
    snap = Snapshot({"g": g, "d": d})
    with no_tf32():
        for i, batch in enumerate(batches):
            alpha = torch.rand((len(batch["aux"]), 1, 1, 1), generator=gen, device=device)
            if fault == "half_batch":
                half = len(batch["aux"]) // 2
                batch, alpha = {k: v[:half] for k, v in batch.items()}, alpha[:half]
            r = step(batch, alpha)
            snap.losses.append((r["g_loss"], r["d_loss"]))
            if i == 0:
                snap.g_out = r["g_out"]
                snap.grads = {
                    "g": {n: v for (n, _), v in zip(g.named_parameters(), r["g_grad_norms"])
                          if np.isfinite(v)},
                    "d": {n: v for (n, _), v in zip(d.named_parameters(), r["d_grad_norms"])
                          if np.isfinite(v)}}
    snap.changed()
    return snap.readings()


def milestones(o: dict) -> list:
    """The MultiStep milestone epochs (the trainer's rule)."""
    return [i * o["lr_milestone"] - 1 for i in range(1, max(1, o["epochs"] // o["lr_milestone"]))]


# a parameter's norm is judged against its own, or this share of the
# median parameter's where it is smaller (gradients all but nought)
FLOOR = 1e-2


def _gap(side: dict, ref: dict) -> float:
    """The widest |side − ref| / max(ref, FLOOR × the median ref) over
    `ref`'s names."""
    return max(_gaps(side, ref).values())


def _gaps(side: dict, ref: dict) -> dict:
    floor = FLOOR * float(np.median(list(ref.values())))
    return {n: abs(side.get(n, 0.0) - r) / max(r, floor) for n, r in ref.items()}


def _moved(ref: dict, m: str) -> list:
    """The parameters of model `m` whose first reference gradient is at least
    a thousandth of the model's median: the others move by round-off alone
    under Adam."""
    med = float(np.median(list(ref["grads"][m].values())))
    return [n for n, r in ref["grads"][m].items() if r >= 1e-3 * med]


def compare(side: dict, ref: dict) -> dict:
    """The numbers the comparison reads, each the worst case (a cell's
    limits name those it holds):
    - g_out_rel_rms: the rms gap of the generator's output in the first
      step over the rms of the reference's (the rows both have);
    - first_loss_gap: |side − ref| / |ref| of the first step's generator
      and critic losses;
    - g_grad_norm_gap, d_grad_norm_gap: over the generator's (critic's)
      parameters, |‖g_side‖ − ‖g_ref‖| / ‖g_ref‖ of the first gradients
      (`_gaps`: under FLOOR × the median ‖g_ref‖, against that);
    - change_norm_gap: the same of each parameter's change over the first
      steps, generator and critic, over the parameters `_moved` names."""
    n = min(len(side["g_out"]), len(ref["g_out"]))
    a, b = side["g_out"][:n].double(), ref["g_out"][:n].double()
    out = {"g_out_rel_rms": float((a - b).square().mean().sqrt() / b.square().mean().sqrt()),
           "first_loss_gap": max(abs(s - r) / abs(r)
                                 for s, r in zip(side["losses"][0], ref["losses"][0]))}
    for m in ("g", "d"):
        out[f"{m}_grad_norm_gap"] = _gap(side["grads"][m], ref["grads"][m])
    out["change_norm_gap"] = max(
        _gap(side["change"][m], {k: ref["change"][m][k] for k in _moved(ref, m)})
        for m in ("g", "d"))
    return out


def detail(side: dict, ref: dict) -> dict:
    """Each step's gaps of both losses, and the parameters with the widest
    gradient and change gaps."""
    out = {"loss_gaps": [[abs(s - r) / abs(r) for s, r in zip(sp, rp)]
                         for sp, rp in zip(side["losses"], ref["losses"])]}
    for m in ("g", "d"):
        grads = _gaps(side["grads"][m], ref["grads"][m])
        change = _gaps(side["change"][m], {k: ref["change"][m][k] for k in _moved(ref, m)})
        out[f"{m}_grad_worst"] = sorted(grads.items(), key=lambda kv: -kv[1])[:3]
        out[f"{m}_change_worst"] = sorted(change.items(), key=lambda kv: -kv[1])[:3]
    return out


def leaves(side: dict, ref: dict) -> dict:
    """Each parameter's norms, [side, reference], of its first gradient and
    of its change."""
    return {m: {kind: {n: [side[kind][m].get(n, 0.0), r] for n, r in ref[kind][m].items()}
                for kind in ("grads", "change")} for m in ("g", "d")}


def reference_batches(cell, store: dict, loader_seed: int, steps: int, device) -> list:
    """The first `steps` batches by the loader's rule, frozen from the
    port's `DeviceLoader` (its base `PrefetchLoader`'s): epoch e's order is
    `numpy.random.default_rng(loader_seed + e).permutation(n)`, batch b its
    b-th run of `batch` indices (the last one shorter); gathered from the
    benchmark's store."""
    n, size = len(store["aux"]), cell.traffic["batch"]
    per_epoch = -(-n // size)
    out = []
    for i in range(steps):
        order = np.random.default_rng(loader_seed + i // per_epoch).permutation(n)
        idx = order[(i % per_epoch) * size:(i % per_epoch + 1) * size]
        out.append({k: torch.from_numpy(v[idx]).to(device) for k, v in store.items()})
    return out


def batch_gap(served: list, ref: list) -> float:
    """The largest |served − reference| over every value of the batches."""
    return max(float((a[k].to(b[k].device) - b[k]).abs().max()) for a, b in zip(served, ref)
               for k in b)


def blocks_fwd_bwd_s(model, captured: tuple, reps: int = 5) -> float:
    """Seconds of the generator blocks' forward and autograd backward on the
    activations (and keyword arguments) captured from the step's call of
    the first block (CUDA events; 2 warm-up calls)."""
    args, kwargs = captured
    x0, a0 = (t.detach().requires_grad_(True) for t in args[:2])
    gen = torch.Generator(device=x0.device).manual_seed(0)
    dy = torch.randn(x0.shape, generator=gen, device=x0.device).to(x0.dtype)

    def once():
        x, a = x0, a0
        for blk in model.blocks:
            x, a = blk(x, a, *args[2:], **kwargs)
        x.backward(dy)

    for _ in range(2):
        once()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        once()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3 / reps


def setup(cell) -> tuple:
    """(training object, its feed, the comparison's readings of its first
    steps, the batches they took, the store, the loader's seed): set-up's
    first steps go through the window's own call and feed."""
    t, device = cell.traffic, cell.device
    cfg = program.config(cell.config, weights.subseed(cell.seed, 0), batch_size=t["batch"])
    program.prepare_training(cfg)
    g_state, d_state = seeded_states(cell, device)
    store = make_store(cell, device)
    tr = program.Training(cfg, g_state, d_state, store, cfg.seed,
                          weights.stream(cell.seed, weights.GP_ALPHA, device), device)
    del g_state, d_state
    feed = tr.batches()
    beta1 = cell.config["optimizer"]["betas"][0]
    snap = Snapshot({"g": tr.g, "d": tr.d})
    first, losses = [], []
    for i in range(t["first_steps"]):
        batch = next(feed)
        first.append({k: v.clone() for k, v in batch.items()})
        if i == 0:
            hook = tr.g.register_forward_hook(
                lambda _m, _args, out: setattr(snap, "g_out", out.detach().float().clone()))
        losses.append(tr(batch))
        if i == 0:
            hook.remove()
            snap.grads = {"g": first_grads(tr.g, tr.step.g_opt, beta1),
                          "d": first_grads(tr.d, tr.step.d_opt, beta1)}
    snap.changed()
    snap.losses = [(float(m["g_loss"]), float(m["d_loss"])) for m in losses]
    return tr, feed, snap.readings(), first, store, cfg.seed


def reference_check(cell, side: dict, first: list, store: dict, loader_seed: int) -> tuple:
    """(the numbers compared, the reference's readings, its batches): the
    reference's first steps on batches it gathers itself, held against the
    program's `side` and `first`, the batches its loader served."""
    batches = reference_batches(cell, store, loader_seed, len(first), cell.device)
    ref = reference_side(cell, batches, Arith("f32"), Arith("f32"), cell.device)
    return {**compare(side, ref), "loader_batch_gap": batch_gap(first, batches)}, ref, batches


class _Capture:
    """A forward pre-hook on the first generator block that keeps its first
    call's activations and arguments."""

    def __init__(self, model) -> None:
        self.args = None
        self.handle = model.blocks[0].register_forward_pre_hook(self._keep, with_kwargs=True)

    def _keep(self, _module, args, kwargs):
        if self.args is None:
            self.args = ((args[0].detach(), args[1].detach(), *args[2:]), kwargs)

    def close(self) -> None:
        self.handle.remove()


def run(cell) -> dict:
    t, device = cell.traffic, cell.device
    tr, feed, side, first, store, loader_seed = setup(cell)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - cell.t0

    capture = []
    sched = Schedule(cell.trace, t["trace_after"], t["trace_items"], t["attrib_items"],
                     hooks=lambda: capture.append(_Capture(tr.g)) or capture[-1])
    losses, waits = [], []
    start = time.perf_counter()
    while time.perf_counter() - start < cell.seconds:
        k = len(losses)
        sched.before(k)
        spans = sched.active is not None and sched.active is sched.attrib
        w0 = time.perf_counter()
        with _maybe("bench.loader", spans):
            batch = next(feed)
        waits.append(time.perf_counter() - w0)
        with _maybe("bench.step", spans):
            m = tr(batch)
        losses.append(m["g_loss"])
        if k % t["sync_every"] == 0:
            float(m["g_loss"])
        sched.after(k)
    sched.finish()
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    steps, batch_n = len(losses), t["batch"]
    readings, trace = {"kind": "train"}, None
    if cell.trace:
        trace = sched.readings(steps, window_s)
        w, p = cell.config["widths"], batch_n * t["patch"] ** 2
        fwd = counts.block_fwd_flops(w, p)
        bound = w["num_blocks"] * counts.bound_s(
            3 * fwd, counts.block_bytes(w, p, False) + counts.block_bytes(w, p, True))
        readings.update(
            trace=trace, items_per_s=sched.rate(steps, window_s) * batch_n,
            flops_per_item=counts.step_flops(w, cell.config["critic"], t["patch"]),
            loader_wait_ms=1e3 * float(np.mean(waits)))
        if device.type == "cuda" and capture and capture[0].args is not None:
            readings["blocks"] = {"bound_s": bound,
                                  "device_s": blocks_fwd_bwd_s(tr.g, capture[0].args)}
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    del tr, feed, capture, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = reference_check(cell, side, first, store, loader_seed)[0]
    return {
        "setup_s": setup_s, "attempted": steps, "failed": failed,
        "end_to_end": {"train_patches_per_s": steps * batch_n / window_s,
                       "peak_mem_gib": peak / 2**30},
        "memory_peak_bytes": peak, "checks": checks, "readings": readings,
        "trace": trace,
    }
