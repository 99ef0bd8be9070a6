"""Device selection and description (``spark_rapids_tpu/runtime/device.py``
counterpart).

Entry points run on the CUDA card.  The CPU is used only when the caller
asks for it (``device="cpu"``), as the CPU tests do; a request for CUDA on a
host without a usable card raises instead of falling back.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Optional, Union

import torch

__all__ = ["DeviceManager", "DeviceInfo", "resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The explicit ``torch.device`` a session runs on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "spark_rapids_tpu_torch runs on a CUDA device by default, "
                "and torch.cuda.is_available() is False here; pass "
                "device='cpu' to run on the host instead")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclass(frozen=True)
class DeviceInfo:
    device: torch.device
    name: str
    memory_bytes: Optional[int]
    power_limit: Optional[str]   # as nvidia-smi reports it, e.g. "700.00 W"


def _nvidia_smi(query: str, index: int) -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
             f"--id={index}"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


class DeviceManager:
    """Describes the device a session was bound to."""

    @staticmethod
    def describe(device: torch.device) -> DeviceInfo:
        if device.type != "cuda":
            return DeviceInfo(device, "cpu", None, None)
        props = torch.cuda.get_device_properties(device)
        return DeviceInfo(device, torch.cuda.get_device_name(device),
                          props.total_memory,
                          _nvidia_smi("power.limit", device.index))
