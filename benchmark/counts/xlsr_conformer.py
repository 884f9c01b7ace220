"""Operations of XLSR-Conformer, computed from shapes: the front-end and
encoder as ``xlsr_aasist.py`` counts them, then the Conformer head.

The head counts two operations a multiply-add of every matmul and
convolution: LL, and in each block the two feed-forwards, q, k and v, the
three products of the relative-position attention (Q Kᵀ, Q against the
position embeddings, P V), the output projection, the conv module's two
pointwise convs and its depthwise conv, over the frames and the class
token; then fc5. Norms, activations, softmax and the embeddings' gather
are left out, as in ``xlsr_aasist.py``. Its hand-written kernels are the
encoder's: the head runs none.
"""

from __future__ import annotations

from benchmark.counts.xlsr_aasist import (encoder_flops, frontend_flops,
                                          kernels, num_frames)

__all__ = ["forward_flops", "head_flops", "kernels", "num_frames"]


def head_flops(cfg: dict, frames: int) -> float:
    """The Conformer head over ``frames`` encoder frames."""
    be = cfg["backend"]
    e, n = be["emb_size"], frames + 1                       # class token
    ff = be["ff_mult"] * e
    inner = be["conv_expansion_factor"] * e
    block = (2 * 2.0 * (2 * n * e * ff)                     # ff1, ff2
             + 2.0 * n * e * 3 * e                          # q, k, v
             + 3 * 2.0 * n * n * e                          # Q Kᵀ, Q E, P V
             + 2.0 * n * e * e                              # out
             + 2.0 * n * e * 2 * inner                      # pointwise 1
             + 2.0 * n * inner * be["kernel_size"]          # depthwise
             + 2.0 * n * inner * e)                         # pointwise 2
    return (2.0 * frames * cfg["hidden_size"] * e           # LL
            + be["n_encoders"] * block + 2.0 * e * 2)       # blocks, fc5


def forward_flops(cfg: dict, samples: int) -> float:
    """Model operations of one clip of ``samples`` samples."""
    t = num_frames(cfg, samples)
    return (frontend_flops(cfg, samples) + encoder_flops(cfg, t)
            + head_flops(cfg, t))
