"""Frozen dataclasses of tensors: the port's stand-in for JAX pytrees."""

from __future__ import annotations

import dataclasses

import torch


class TensorGroup:
    """Mixin for frozen dataclasses whose fields are tensors, nested
    groups, None or plain values.  `.map_tensors(fn)` returns a copy with
    fn applied to every tensor (recursively), `.to(device)` one with every
    tensor on `device`; other fields are kept as they are."""

    def map_tensors(self, fn):
        def apply(value):
            if isinstance(value, torch.Tensor):
                return fn(value)
            if isinstance(value, TensorGroup):
                return value.map_tensors(fn)
            return value

        return dataclasses.replace(
            self,
            **{f.name: apply(getattr(self, f.name))
               for f in dataclasses.fields(self)},
        )

    def to(self, device):
        return self.map_tensors(lambda t: t.to(device))
