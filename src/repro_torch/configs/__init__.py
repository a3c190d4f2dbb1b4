"""Architecture registry (port of repro/configs/__init__.py).

Each module defines `CONFIG` (the published widths) and `smoke_config()`
(the reduced float32 config the tests use).  Every arch of the
reference is registered: the decoder families the paged engine serves,
dense, moe (dbrx, arctic), hybrid (jamba) and ssm (xlstm), and the
encoder-decoder (whisper) and VLM (paligemma) families, which run
through the unpaged decode path only.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ArchConfig

_ARCH_MODULES = {
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    # The paper's own transformer benchmark backbones (Table 2):
    "bert-base": "repro_torch.configs.bert_base",
    "vit-b-16": "repro_torch.configs.vit_b_16",
    # The recurrent, hybrid and MoE families:
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    # The unpaged families:
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_smoke(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[name]).smoke_config()
