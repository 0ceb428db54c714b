"""Safetensors <-> torch weight I/O, with no dependency on `safetensors`.

The format is an 8-byte little-endian header length, a JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__": ...}
and the raw little-endian tensor bytes. Reading it directly keeps BF16
native (torch has the type; numpy does not) and keeps the port free of
packages the GPU machine may lack.

Semantics match `deepseek_ocr2_tpu.io.safetensors_io`: a copy of its
`DtypePolicy` (longest-prefix per-tensor cast of float tensors),
`include_regex` partial loads and `LoadReport` bookkeeping.
"""

from __future__ import annotations

import dataclasses
import json
import re
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass
class DtypePolicy:
    """Per-prefix dtype cast policy for float tensors (copy of the JAX
    package's; `apply_policy` below is its `apply` for torch tensors).

    Equivalent of the reference's `SelectiveCastDTypeAdapter`
    (store_adapters.rs:105-167): a default target dtype plus longest-match
    per-prefix overrides. Non-float tensors are never cast. A target of
    ``None`` keeps the stored dtype.
    """

    default: Optional[str] = "bfloat16"
    prefixes: Dict[str, Optional[str]] = dataclasses.field(default_factory=dict)

    def with_prefix(self, prefix: str, dtype: Optional[str]) -> "DtypePolicy":
        new = dict(self.prefixes)
        new[prefix] = dtype
        return DtypePolicy(default=self.default, prefixes=new)

    def target_for(self, name: str) -> Optional[str]:
        best: Optional[str] = self.default
        best_len = -1
        for prefix, dtype in self.prefixes.items():
            if name.startswith(prefix) and len(prefix) > best_len:
                best = dtype
                best_len = len(prefix)
        return best


@dataclasses.dataclass
class LoadReport:
    """Load bookkeeping (reference main.rs:832-838)."""

    applied: List[str] = dataclasses.field(default_factory=list)
    missing: List[str] = dataclasses.field(default_factory=list)
    skipped: List[str] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)

    def merge(self, other: "LoadReport") -> None:
        self.applied.extend(other.applied)
        self.missing.extend(other.missing)
        self.skipped.extend(other.skipped)
        self.errors.extend(other.errors)

    def summary(self) -> str:
        return (
            f"loaded: applied={len(self.applied)}, missing={len(self.missing)}, "
            f"skipped={len(self.skipped)}, errors={len(self.errors)}"
        )

    def raise_on_errors(self) -> None:
        if self.errors:
            raise ValueError("weight load errors:\n" + "\n".join(self.errors))

_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "F64": torch.float64,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_TORCH_FROM_STR = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


def _read_header(f) -> Tuple[dict, int]:
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def inspect_safetensors(path: str) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, dtype) of every tensor, sorted by name, from the header
    alone (the JAX package's `inspect_safetensors`, without `safetensors`);
    dtype is the header's string, e.g. "F32" or "BF16"."""
    with open(path, "rb") as f:
        header, _ = _read_header(f)
    return [(name, tuple(header[name]["shape"]), header[name]["dtype"]) for name in sorted(header)]


def apply_policy(policy: DtypePolicy, name: str, t: torch.Tensor) -> torch.Tensor:
    """`DtypePolicy.apply` for torch tensors: casts float tensors only."""
    target = policy.target_for(name)
    if target is None or not t.is_floating_point():
        return t
    dtype = _TORCH_FROM_STR[target]
    return t if t.dtype == dtype else t.to(dtype)


def load_flat(
    paths: Union[Sequence[str], str],
    policy: Optional[DtypePolicy] = None,
    include_regex: Optional[Iterable[str]] = None,
) -> Dict[str, torch.Tensor]:
    """Load tensors from one or more safetensors files into a flat dict of
    CPU tensors, with `policy` applied per tensor name."""
    if isinstance(paths, str):
        paths = [paths]
    patterns = [re.compile(r) for r in include_regex] if include_regex else None
    policy = policy or DtypePolicy(default=None)
    flat: Dict[str, torch.Tensor] = {}
    for path in paths:
        with open(path, "rb") as f:
            header, base = _read_header(f)
            for name, meta in header.items():
                if patterns is not None and not any(p.search(name) for p in patterns):
                    continue
                if meta["dtype"] not in _DTYPES:
                    raise ValueError(f"{path}: {name} has unsupported dtype {meta['dtype']}")
                begin, end = meta["data_offsets"]
                f.seek(base + begin)
                buf = bytearray(f.read(end - begin))
                dtype = _DTYPES[meta["dtype"]]
                if buf:
                    t = torch.frombuffer(buf, dtype=dtype)
                else:
                    t = torch.empty(0, dtype=dtype)
                flat[name] = apply_policy(policy, name, t.reshape(meta["shape"]))
    return flat


def as_tensor(v) -> torch.Tensor:
    """A torch tensor for a tensor or numpy array (ml_dtypes bf16 included);
    read-only arrays are copied, since torch tensors are writable."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.ascontiguousarray(v)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes array: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_flat(flat: Dict[str, Union[torch.Tensor, np.ndarray]], path: str) -> None:
    """Write a flat {name: tensor or array} dict as a safetensors file."""
    header = {}
    blobs = []
    offset = 0
    for name in sorted(flat):
        t = as_tensor(flat[name]).detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {
            "dtype": _NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(data)],
        }
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # keep the data section 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in blobs:
            f.write(data)


class FlatSource:
    """Consumes a flat dict while building parameters; records applied and
    missing names, and (on `finish`) untouched ones as skipped. Values are
    moved to `device` as torch tensors in HF layout (no transposes)."""

    def __init__(self, flat: Dict[str, object], device: torch.device, policy: DtypePolicy):
        self.flat = flat
        self.device = device
        self.policy = policy
        self.report = LoadReport()
        self._taken: set = set()

    def take(self, name: str) -> Optional[torch.Tensor]:
        if name not in self.flat:
            self.report.missing.append(name)
            return None
        self._taken.add(name)
        self.report.applied.append(name)
        t = apply_policy(self.policy, name, as_tensor(self.flat[name]))
        return t.to(self.device)

    def finish(self) -> LoadReport:
        for name in self.flat:
            if name not in self._taken:
                self.report.skipped.append(name)
        return self.report
