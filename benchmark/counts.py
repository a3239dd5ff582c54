"""The benchmark's own operation and byte counts, and the chip's peaks.

Counted from a configuration's widths, never read from the program. An
operation count is the FLOP of the products and convolutions the plain
reference (`benchmark/reference/`) runs: 2·m·n·k a product, 2·(output
elements)·(kernel elements)·(input channels) a convolution, forward and
backward, as `torch.utils.flop_counter.FlopCounterMode` counts them; no
elementwise operation counts. `benchmark/tests/test_counts.py` holds every
count equal to FlopCounterMode over the reference.

Bytes follow the roofline rule: each input byte read once and each output
byte written once, activations in the configuration's dtype (bfloat16, 2
bytes) and parameters as stored (float32, 4 bytes), whatever a kernel
reads again. `bound` is the larger of the bytes over HBM bandwidth and the
operations over the dense bfloat16 tensor-core peak: no implementation of
the configuration's arithmetic can be faster on this card.
"""

from __future__ import annotations

import math

# one H100 SXM's published dense peaks (NVIDIA's data sheet)
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12
ACT_BYTES, PARAM_BYTES = 2, 4


def bound_s(flops: float, moved: float) -> float:
    """The least seconds the card could take: max(FLOP / bf16 peak,
    bytes / HBM bandwidth)."""
    return max(flops / PEAK_FLOPS["bf16"], moved / HBM_BYTES_S)


def conv(pixels: int, k: int, cin: int, cout: int) -> int:
    """FLOP of a k×k convolution producing `pixels` output pixels."""
    return 2 * pixels * k * k * cin * cout


def encoder(pixels: int, cin: int, enc: int) -> int:
    """The three parallel 1/3/5 encoder convs."""
    return sum(conv(pixels, k, cin, enc) for k in (1, 3, 5))


def block_fwd_flops(w: dict, pixels: int) -> int:
    """One generator block's forward over `pixels` pixels (a batch's)."""
    c = w["base_ch"]
    ffn = 2 * conv(pixels, 3, c, c)
    if w["model"] == "afgsa":
        win = w["block_size"] + 2 * w["halo_size"]
        # 1×1 fuse (2c → c), q, k, v, then q·kᵀ and p·v over each window
        return conv(pixels, 1, 2 * c, c) + 3 * conv(pixels, 1, c, c) + 4 * pixels * win**2 * c + ffn
    di, n, q = w["expansion"] * c, w["d_state"], 128
    h = di // w["headdim"]
    proj = 2 * pixels * c * (2 * di + 2 * n + h) + 2 * pixels * di * c
    # the chunked SSD: chunk states, C·Bᵀ, the intra-chunk products and the
    # entering states' readout
    ssd = 2 * pixels * (2 * n * di + q * n + q * di)
    return proj + ssd + ffn


def block_bytes(w: dict, pixels: int, backward: bool) -> int:
    """A block's bytes: the forward reads its input features (AFGSA: the
    noisy and aux features) and the parameters and writes its output; the
    backward reads those and the output gradient and writes the input and
    parameter gradients."""
    c = w["base_ch"]
    img = pixels * c * ACT_BYTES
    ins = 2 if w["model"] == "afgsa" else 1
    params = block_params(w) * PARAM_BYTES
    if not backward:
        return ins * img + img + params
    return ins * img + img + ins * img + 2 * params


def block_params(w: dict) -> int:
    c = w["base_ch"]
    ffn = 2 * (9 * c * c + c)
    if w["model"] == "afgsa":
        win, hd = w["block_size"] + 2 * w["halo_size"], c // w["num_heads"]
        return 2 * c * c + c + 3 * c * c + 2 * win * (hd // 2) + ffn
    di, n = w["expansion"] * c, w["d_state"]
    h, cd = di // w["headdim"], di + 2 * n
    return (2 * c + c * (2 * di + 2 * n + h) + w["d_conv"] * cd + cd + 3 * h + di
            + di * c + ffn)


def g_fwd_flops(w: dict, side: int) -> int:
    """The generator's forward over one side² window (batch 1)."""
    p, c, e = side * side, w["base_ch"], w["enc_ch"]
    cin, caux = w["input_channels"], w["aux_input_channels"]
    f = encoder(p, cin, e) + conv(p, 1, 3 * e, c)
    if w["model"] == "afgsa":   # the Mamba generator does not run its aux branch
        f += encoder(p, caux, e) + conv(p, 1, 3 * e, c) + conv(p, 1, c, c)
    f += w["num_blocks"] * block_fwd_flops(w, p)
    return f + 2 * conv(p, 3, c, c) + conv(p, 3, c, cin)


def g_input_layer_flops(w: dict, side: int) -> int:
    """The generator's convs that read the batch itself (no input gradient)."""
    p, e = side * side, w["enc_ch"]
    f = encoder(p, w["input_channels"], e)
    if w["model"] == "afgsa":
        f += encoder(p, w["aux_input_channels"], e)
    return f


def critic_flops(crit: dict, side: int) -> tuple:
    """(all convolutions, the first convolution, the first dense layer, the
    second) FLOP of the critic's forward over one side² sample."""
    nf, cin = crit["base_nf"], crit["in_nc"]
    first = conv(side * side, 3, cin, nf)
    convs, s = first, side
    for i in range(int(math.log2(crit["input_size"] / 4))):
        nxt = min(crit["base_nf"] * 2 ** (i + 1), crit["base_nf"] * 8)
        convs += conv(s * s, 3, nf, nxt)
        s //= 2
        convs += conv(s * s, 4, nxt, nxt)
        nf = nxt
    return convs, first, 2 * nf * s * s * 100, 2 * 100


def step_flops(w: dict, crit: dict, side: int) -> int:
    """One WGAN-GP + L1 step of the reference, per sample of side².

    The generator: forward, and backward to every parameter and to every
    activation but the batch (2·forward − its input layer). The critic,
    with convolutions `cv` (the first `c1`), dense layers `d0`, `d1`:
    - real and fake forwards, and the interpolate's forward: 3 forwards;
    - the gradient penalty's input gradient: every layer's input gradient;
    - the critic's backward: on real and fake, every weight gradient and
      every input gradient but the first conv's; on the penalty, the
      second-order pass, in which each input-gradient product of the
      previous item takes its two gradients, where the output's seed
      gradient (all ones) takes none (d1 once), and the interpolate's
      forward takes its weight and input gradients (again not the first
      conv's) up to d0, since no gradient of the first item reads d1's
      input;
    - the generator's turn: a forward, and every input gradient.
    """
    fg, fin = g_fwd_flops(w, side), g_input_layer_flops(w, side)
    cv, c1, d0, d1 = critic_flops(crit, side)
    fd = cv + d0 + d1
    d_step = 3 * fd + fd + 2 * (2 * fd - c1) + (2 * cv + 2 * d0 + d1) + (2 * (cv + d0) - c1)
    g_turn = 2 * fd
    return fg + (2 * fg - fin) + d_step + g_turn


def frame_windows(frame_hw: tuple, tile: int) -> int:
    """The windows a frame needs: ⌈H/tile⌉·⌈W/tile⌉ (no wrap-around padding)."""
    return -(-frame_hw[0] // tile) * -(-frame_hw[1] // tile)


def config_counts(w: dict, crit: dict, side: int, batch: int) -> dict:
    """The counts a configuration file records, at its side² windows and its
    batch of `batch` windows (or patches)."""
    p = batch * side * side
    fwd, bwd = block_fwd_flops(w, p), 2 * block_fwd_flops(w, p)
    return {
        "g_fwd_flops_per_window": g_fwd_flops(w, side),
        "step_flops_per_sample": step_flops(w, crit, side),
        "block_fwd_flops_per_batch": fwd,
        "block_bwd_flops_per_batch": bwd,
        "block_fwd_bytes_per_batch": block_bytes(w, p, False),
        "block_bwd_bytes_per_batch": block_bytes(w, p, True),
    }
