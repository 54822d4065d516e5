"""The reference's backbones, one module a backbone: the name a
configuration gives in `model.backbone` is the module `<name>.py` of this
package, so that a configuration with a new backbone brings one new file
and edits none.

A backbone module exports
  * `DIMS`: the channels of its feature pyramid, coarse last;
  * `Features`: a plain-torch `nn.Module` that maps an NCHW batch to that
    pyramid, a list of NCHW maps at strides ..., 8, 16, 32 (coarse last).
It builds on the blocks of `posebench/reference/model.py` (`Conv2d`,
`Dense`, `BatchNorm`, `BasicBlock`, `Bottleneck`, a `Q` layer's rounding `q`,
`run`), so that `set_quant` and `set_checkpointing` reach it. A module of it
whose tensors `posebench/weights.py` should not draw by its default rules
declares their draws in a class attribute `draws` (see `weights.py`).
"""
from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path
from types import ModuleType


def load(name: str) -> ModuleType:
    """The module of the backbone `name`; a ValueError naming the file it
    looked for where there is none."""
    spec = (importlib.util.find_spec(f"{__name__}.{name}")
            if name.isidentifier() else None)
    if spec is None:
        raise ValueError(f"no reference backbone {name!r}: "
                         f"{Path(__file__).parent / f'{name}.py'} does not exist")
    return importlib.import_module(spec.name)
