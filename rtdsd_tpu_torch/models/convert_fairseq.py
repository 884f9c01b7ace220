"""SSL initialisation from a pre-trained checkpoint: the part of
``rtdsd_tpu/models/convert_fairseq.py`` that training needs.

:func:`encoder_state_dict` turns a fairseq wav2vec2 / XLS-R ``.pt``
(``{"model": {...}}`` with fairseq's names, which the port's encoder keeps)
or a reference-named model ``.pt`` (its ``ssl_model.model.*`` keys) into the
encoder's state dict: the pre-training heads (``mask_emb``, ``quantizer``,
``project_q``, ``final_proj``, ``label_embs_concat``, ``target_glu``) are
dropped and the positional conv's weight norm is folded into one weight.
"""

from __future__ import annotations

import re
from typing import Mapping, Union

import torch

from rtdsd_tpu_torch.models.convert import StateDict, load_reference_state_dict

_PREFIX = "ssl_model.model."
_HEADS = re.compile(r"^(mask_emb$|quantizer\.|project_q\.|final_proj\.|"
                    r"label_embs_concat$|target_glu\.)")


def encoder_state_dict(path_or_dict: Union[str, Mapping]) -> StateDict:
    """A fairseq or reference-named ``.pt`` (or its dict) -> the state dict
    of a ``Wav2Vec2Encoder`` (keys without the ``ssl_model.model.``
    prefix)."""
    obj = path_or_dict
    if isinstance(obj, str):
        obj = torch.load(obj, map_location="cpu", weights_only=False)
    if isinstance(obj.get("model"), Mapping):
        obj = obj["model"]
    if isinstance(obj.get("state_dict"), Mapping):
        obj = obj["state_dict"]
    obj = {k[len("module."):] if k.startswith("module.") else k: v
           for k, v in obj.items()}
    if not any(k.startswith(_PREFIX) for k in obj):      # fairseq names
        obj = {_PREFIX + k: v for k, v in obj.items()
               if isinstance(v, torch.Tensor) and not _HEADS.search(k)}
    sd = load_reference_state_dict(obj)
    return {k[len(_PREFIX):]: v for k, v in sd.items() if k.startswith(_PREFIX)}
