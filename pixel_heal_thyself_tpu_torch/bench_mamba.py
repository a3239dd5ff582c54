"""Time the Mamba2 denoiser's sections (port of `tools/bench_mamba.py`).

    python -m pixel_heal_thyself_tpu_torch.bench_mamba [--batch 4] [--patch 128]
        [--iters 10] [--pallas] [--mega] [--device cuda|cpu]

The sections of the JAX tool, at its defaults (batch 4 of 128² patches,
16,384 tokens per sample; the reference `config/model/mamba.yaml` dims,
bf16, seeded random weights): the MambaDenoiserNet forward, its L1
forward + backward, one Mamba2Layer forward + backward at the in-model
sequence shape, the SSD core (d_inner 1024, 16 heads of 64, d_state 64)
forward + backward through `ssd_chunked`, and the `ssd_chunked` forward
against the `ssd_pallas` forward. `--pallas` takes the fused conv1d +
SiLU on the literal route (kernels K9/K10) and `--mega` the fused layer
interior (K7/K8), the JAX tool's `PHT_MAMBA_PALLAS=1` and
`PHT_MAMBA_MEGA=1`; the models run their kernels (`use_kernels`). The
`ssd_pallas` section runs K11 on the card.

It runs on the card unless `--device cpu` is given. On the card each
section is timed with CUDA events over `--iters` calls after two warm-up
calls, and its peak device memory is read; on the CPU the host clock
times it and no memory is read. PyTorch runs eagerly and does not dedupe
identical calls, so the JAX tool's chaining of each output into the next
input is not needed.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

D_MODEL, HEADS, HEADDIM, D_STATE = 256, 16, 64, 64


def make_inputs(batch: int, patch: int, device) -> dict:
    """The JAX tool's inputs, drawn in its order from numpy seed 0."""
    rng = np.random.default_rng(0)
    tokens = patch * patch

    def t(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)

    bf = torch.bfloat16
    data = {
        "noisy": t(np.abs(rng.standard_normal((batch, patch, patch, 3)))),
        "gt": t(np.abs(rng.standard_normal((batch, patch, patch, 3)))),
        "aux": t(rng.standard_normal((batch, patch, patch, 7))),
        "seq": t(rng.standard_normal((batch, tokens, D_MODEL)), bf),
        "xs": t(rng.standard_normal((batch, tokens, HEADS, HEADDIM)), bf),
        "dts": t(rng.standard_normal((batch, tokens, HEADS)), bf).abs(),
    }
    data["A"] = -torch.ones(HEADS, dtype=bf, device=device)
    data["Bs"] = t(rng.standard_normal((batch, tokens, 1, D_STATE)), bf)
    data["Cs"] = t(rng.standard_normal((batch, tokens, 1, D_STATE)), bf)
    return data


def make_model(pallas: bool, mega: bool, use_kernels: bool, device):
    """The prod-width MambaDenoiserNet of the JAX tool (bf16, num_gcp 0),
    seeded random weights."""
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet

    return MambaDenoiserNet(dtype=torch.bfloat16, num_gcp=0, use_pallas=pallas,
                            use_megakernel=mega, use_kernels=use_kernels, device=device,
                            generator=torch.Generator().manual_seed(0))


def g_fwd(model, data) -> torch.Tensor:
    """The generator's forward (no grad)."""
    with torch.no_grad():
        return model(data["noisy"], data["aux"])


def g_fwd_bwd(model, data) -> dict:
    """The generator's L1 loss against gt, forward and backward: the
    parameters' gradients by name."""
    model.zero_grad(set_to_none=True)
    loss = (model(data["noisy"], data["aux"]) - data["gt"]).abs().mean()
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def time_section(name: str, fn, iters: int, device) -> dict:
    """Two warm-up calls, then `iters` timed ones: ms per call and, on the
    card, the peak device memory of the section."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        fn()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms, peak = start.elapsed_time(end) / iters, torch.cuda.max_memory_allocated()
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms, peak = (time.perf_counter() - t0) / iters * 1e3, None
    mem = "peak not measured (CPU)" if peak is None else f"peak {peak / 2**30:.3f} GiB"
    print(f"{name:34s} {ms:10.3f} ms  {mem}", flush=True)
    return {"ms": ms, "peak_bytes": peak}


def run(batch: int = 4, patch: int = 128, iters: int = 10, pallas: bool = False,
        mega: bool = False, device="cuda") -> dict:
    """Every section: {name: {"ms", "peak_bytes"}}."""
    from pixel_heal_thyself_tpu_torch.models.mamba import Mamba2Layer
    from pixel_heal_thyself_tpu_torch.ops.ssd import ssd_chunked, ssd_pallas

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_mamba: no CUDA device (pass --device cpu for the CPU)")
    data = make_inputs(batch, patch, device)
    model = make_model(pallas, mega, True, device)
    layer = Mamba2Layer(D_MODEL, dtype=torch.bfloat16, use_kernels=True, use_megakernel=mega,
                        use_pallas=pallas, generator=torch.Generator().manual_seed(1)).to(device)
    ssd_args = tuple(data[k] for k in ("xs", "dts", "A", "Bs", "Cs"))

    def layer_fwd_bwd():
        layer.zero_grad(set_to_none=True)
        layer(data["seq"]).abs().float().mean().backward()

    def ssd_fwd_bwd():
        xs = data["xs"].detach().requires_grad_(True)
        ssd_chunked(xs, *ssd_args[1:]).float().abs().mean().backward()

    def no_grad(fn):
        def call():
            with torch.no_grad():
                fn(*ssd_args)
        return call

    sections = {
        "Mamba G fwd": lambda: g_fwd(model, data),
        "Mamba G fwd+bwd (L1)": lambda: g_fwd_bwd(model, data),
        "Mamba2Layer fwd+bwd": layer_fwd_bwd,
        "SSD core fwd+bwd": ssd_fwd_bwd,
        "SSD chunked fwd": no_grad(ssd_chunked),
        "SSD pallas fwd": no_grad(ssd_pallas),
    }
    print(f"bench_mamba: batch {batch} × {patch}², pallas={pallas}, mega={mega}, "
          f"device {device}", flush=True)
    return {name: time_section(name, fn, iters, device) for name, fn in sections.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="bench_mamba")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--patch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--pallas", action="store_true",
                    help="the fused conv1d + SiLU on the literal route (K9/K10)")
    ap.add_argument("--mega", action="store_true", help="the fused layer interior (K7/K8)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run(args.batch, args.patch, args.iters, args.pallas, args.mega, args.device)


if __name__ == "__main__":
    main()
