"""Kernel names → groups of the traced run's `breakdown`.

A frozen copy of the program's `profile_serving.GROUPS` table (kernel-name
fragment → group label, first match wins), kept here so that a change to
the program's table does not change what the benchmark reports.
"""

from __future__ import annotations

# kernel-name fragment → group, first match wins
GROUPS = [
    # K9/K10 (conv_silu.cu) and K11 (ssd_scan.cu): their names hold "conv"
    # and "chunk" too
    ("conv_silu_fwd", "K9 conv1d + SiLU"), ("conv_silu_bwd", "K10 main"),
    ("sum_tiles", "K10 tap/bias sums"), ("scan_cum", "K11 cum"),
    ("scan_chunk_state", "K11 chunk state"), ("scan_state_pass", "K11 state pass"),
    ("scan_state_tc", "K11 chunk state + carry"), ("scan_chunk_output", "K11 chunk output"),
    ("scan_output_tc", "K11 chunk output"),
    # K8's launches first: their names hold "conv" and "norm" too (the
    # chunk output and prologue K8 recomputes carry K7's names). Both bodies
    # share a label where they do the same work; the tensor-core body's
    # fused intra and head rest (ssd_intra_rest_tc_kernel) has its own
    ("ssd_norm_bwd", "K8 norm backward"), ("ssd_dstate_local", "K8 dstate local"),
    ("ssd_dstate_reverse", "K8 reverse state pass"), ("ssd_intra_rest", "K8 intra + head rest"),
    ("ssd_intra_bwd", "K8 intra"), ("ssd_head_bwd", "K8 head rest"),
    ("ssd_bc_bwd", "K8 dB/dC"), ("ssd_bc_tc", "K8 dB/dC"),
    ("ssd_conv_bwd", "K8 conv backward"), ("ssd_conv_transpose", "K8 conv transpose"),
    ("ssd_sum_parts", "K8 parameter sums"),
    ("ssd_chunk_output", "K7 chunk output"), ("ssd_chunk_state", "K7 chunk state"),
    ("ssd_state_pass", "K7 state pass"), ("ssd_prologue", "K7 prologue"),
    ("gated_rmsnorm", "K7 gated RMSNorm"),
    # K1 and K4: the tensor-core bodies (attention_fwd_tc_kernel,
    # attention_bwd_tc_kernel), the float32 and general ones, K4's gather
    # and bias reduce
    ("attention_fwd", "K1 attention"), ("attention_bwd", "K4 attention backward"),
    ("attention_bias_reduce", "K4 attention backward"),
    # K5: its Hopper body (conv3x3_dgrad_sm90_kernel) and general body, its
    # fold pre-pass; the ReLU gate pass that K5 and K6 run
    ("conv3x3_dgrad", "K5 conv3x3 dgrad"), ("dgrad_fold", "K5 fold pre-pass"),
    ("weight_grad", "K6 weight gradient"),
    ("sum_splits", "K6 weight gradient"), ("wgrad_kernel", "K6 weight gradient"),
    ("mask_kernel", "K5/K6 gate pass"), ("conv3x3_kernel", "K3 conv3x3"),
    # K2's Hopper body; its general body, and K3's for widths 8 does not
    # divide (cuBLAS names hold "gemm_bf16")
    ("pointwise_gemm", "K2 GEMM"), ("gemm_bf16_kernel", "K2 GEMM"),
    ("fprop", "cuDNN conv"), ("implicit", "cuDNN conv"), ("conv", "cuDNN conv"),
    ("cudnn", "cuDNN conv"), ("gemm", "cuBLAS GEMM"), ("Kernel2", "cuBLAS GEMM"),
    ("reduce", "reductions"),
    ("Memcpy", "copies"), ("elementwise", "elementwise"), ("index", "gather/scatter"),
]


def group(name: str, groups=GROUPS) -> str:
    for frag, label in groups:
        if frag.lower() in name.lower():
            return label
    return "other"
