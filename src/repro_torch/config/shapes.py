"""Assigned input shapes and their step kinds (field for field the JAX
package's ``repro.config.shapes``).

Decode shapes build the serve step (one new token against a KV cache of
``seq_len``); train and prefill shapes build the train and prefill steps
(``launch.steps.build_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": InputShape("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": InputShape("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": InputShape("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}


def get_shape(name: str) -> InputShape:
    try:
        return INPUT_SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown input shape {name!r}; options: {sorted(INPUT_SHAPES)}")
