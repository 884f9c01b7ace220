"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. With no GPU
present and no explicit ``cpu`` request they raise: a scoring run that
quietly fell back to the CPU would be hours slower and would not say so.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Raises if CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r}; use 'cuda' or 'cpu'")
    return dev
