"""Operations and bytes of XLSR-AASIST, computed from shapes.

Model operations count the multiply-adds of every matmul and convolution
of a forward pass, two operations each, whatever implements them; norms,
activations, softmax and pooling are left out (a few percent at these
widths). The attention kernel's count is its two products, Q Kᵀ and P V,
and its bytes are Q, K and V read once and the output written once.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from benchmark.harness.card import ELEM_BYTES


def conv_frames(conv: Sequence[Tuple[int, int, int]], samples: int) -> list:
    """Output lengths of each layer of the conv stack."""
    out, t = [], samples
    for _c, k, s in conv:
        t = (t - k) // s + 1
        out.append(t)
    return out


def frontend_flops(cfg: dict, samples: int) -> float:
    """The conv feature extractor over ``samples`` samples."""
    conv = list(zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]))
    total, cin = 0.0, 1
    for (c, k, _s), t in zip(conv, conv_frames(conv, samples)):
        total += 2.0 * cin * k * c * t
        cin = c
    return total


def num_frames(cfg: dict, samples: int) -> int:
    conv = list(zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]))
    return conv_frames(conv, samples)[-1]


def encoder_flops(cfg: dict, frames: int) -> float:
    """Projection, positional conv and the transformer layers over
    ``frames`` frames."""
    d, f, t = cfg["hidden_size"], cfg["intermediate_size"], frames
    c = cfg["conv_dim"][-1]
    g, k = cfg["num_conv_pos_embedding_groups"], cfg["num_conv_pos_embeddings"]
    proj = 2.0 * t * c * d
    pos = 2.0 * t * d * (d // g) * k
    layer = (2.0 * t * d * d * 4            # q, k, v, out projections
             + 2.0 * t * d * f * 2          # fc1, fc2
             + 2.0 * 2 * t * t * d)         # Q Kᵀ and P V over all heads
    return proj + pos + cfg["num_hidden_layers"] * layer


def _gat_pairs(n: int, d: int, do: int) -> float:
    """One graph attention layer's pair scores and aggregation over n
    nodes: (x_i * x_j) W for every pair, the edge dot, and the weighted
    sum of the nodes."""
    return 2.0 * n * n * d * do + 2.0 * n * n * do + 2.0 * n * n * d


def backend_flops(cfg: dict, frames: int) -> float:
    """The AASIST back-end over ``frames`` encoder frames."""
    be = cfg["backend"]
    f0 = be["filts"][0]
    g0, g1 = be["gat_dims"]
    blocks = [tuple(b) for b in be["filts"][1:]]
    blocks += [blocks[-1]] * (6 - len(blocks))
    ch = blocks[-1][-1]
    total = 2.0 * frames * cfg["hidden_size"] * f0             # LL
    h, w = f0 // 3, frames // 3                                # max pool 3x3
    for cin, cout in blocks:
        total += 2.0 * (h + 1) * w * cin * cout * 6            # conv1 (2, 3)
        total += 2.0 * h * w * cout * cout * 6                 # conv2 (2, 3)
        if cin != cout:
            total += 2.0 * h * w * cin * cout * 3              # downsample
    total += 2.0 * h * w * (ch * 128 + 128 * ch)               # attention
    n_s, n_t = h, w
    for n in (n_s, n_t):                                       # GAT S, T
        total += _gat_pairs(n, ch, g0) + 2.0 * 2 * n * ch * g0
    r = be["pool_ratios"]
    n_s, n_t = max(int(n_s * r[0]), 1), max(int(n_t * r[1]), 1)
    n2 = max(int(n_s * r[2]), 1) + max(int(n_t * r[2]), 1)
    for n, din in ((n_s + n_t, g0), (n2, g1)):                 # per branch
        total += 2 * (2.0 * n * din * din                      # proj_type
                      + _gat_pairs(n, din, g1)
                      + 2.0 * 3 * n * din * g1                 # projM, with,
                      + 2.0 * 2 * din * g1)                    # without; M
    total += 2.0 * 5 * g1 * 2                                  # out layer
    return total


def forward_flops(cfg: dict, samples: int) -> float:
    """Model operations of one clip of ``samples`` samples."""
    t = num_frames(cfg, samples)
    return (frontend_flops(cfg, samples) + encoder_flops(cfg, t)
            + backend_flops(cfg, t))


def attention_launch(batch: int, frames: int, heads: int, head_dim: int,
                     elem_bytes: int) -> Tuple[float, float]:
    """(operations, bytes) of one ``mha_small_t`` launch on (B, T, H, D)."""
    ops = 4.0 * batch * heads * frames * frames * head_dim
    nbytes = 4.0 * batch * frames * heads * head_dim * elem_bytes
    return ops, nbytes


def kernels(cfg: dict, rows: int, frames: int
            ) -> Dict[str, Tuple[float, float, str]]:
    """{kernel: (operations, bytes, dtype)} of one launch of each kernel
    that ``programs/xlsr_aasist.py::kernels`` lists, at ``rows`` clips of
    ``frames`` encoder frames: the encoder's attention."""
    dtype = cfg["program"]["compute_dtype"]
    heads = cfg["num_attention_heads"]
    ops, nbytes = attention_launch(rows, frames, heads,
                                   cfg["hidden_size"] // heads,
                                   ELEM_BYTES[dtype])
    return {"mha_small_t": (ops, nbytes, dtype)}
