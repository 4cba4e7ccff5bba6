"""Run-metadata stamp for the artifacts the port writes.

Counterpart of ``trustworthy_dl_tpu/obs/meta.py``: the same schema string
and keys, except that ``jax_version`` becomes ``torch_version`` and
``cuda_version`` (the CUDA that torch was built for, None on a CPU
build).  ``device_kind`` is ``torch.cuda.get_device_name`` on the card
and "cpu" without CUDA.  ``run_metadata(host_only=True)`` imports nothing:
the offline readers (forensics, verdicts, the obs command) stamp their
artifacts in processes that never load torch.  Device discovery is cached per process and
degrades to ``platform: "unavailable"`` instead of raising: a metadata
stamp must never be the reason an artifact is lost.
"""

from __future__ import annotations

import functools
import importlib.metadata
import platform as _platform
import sys
import time
from typing import Any, Dict

RUN_METADATA_SCHEMA = "tddl-obs-v1"

#: Keys every stamped artifact carries.
RUN_METADATA_KEYS = (
    "schema", "platform", "device_kind", "num_devices", "torch_version",
    "cuda_version", "python_version", "framework_version", "hostname",
    "timestamp",
)


def _versions() -> Dict[str, Any]:
    try:
        import torch

        return {"torch_version": torch.__version__,
                "cuda_version": torch.version.cuda}
    except Exception:
        return {"torch_version": "unknown", "cuda_version": None}


def _host_versions() -> Dict[str, Any]:
    """The versions without importing torch: the loaded module's when a
    caller already imported it, else the installed distribution's (no
    CUDA version then: only the module knows what it was built for)."""
    if "torch" in sys.modules:
        return _versions()
    try:
        version = importlib.metadata.version("torch")
    except importlib.metadata.PackageNotFoundError:
        version = "unknown"
    return {"torch_version": version, "cuda_version": None}


@functools.lru_cache(maxsize=1)
def _device_info() -> Dict[str, Any]:
    """Backend identity, resolved once per process."""
    info = _versions()
    try:
        import torch

        if torch.cuda.is_available():
            info.update(platform="gpu",
                        device_kind=torch.cuda.get_device_name(0),
                        num_devices=torch.cuda.device_count())
        else:
            info.update(platform="cpu", device_kind="cpu", num_devices=1)
    except Exception as exc:  # a dead CUDA runtime must not lose the artifact
        info.update(platform="unavailable", device_kind="unknown",
                    num_devices=0,
                    backend_error=f"{type(exc).__name__}: {str(exc)[:120]}")
    return info


def run_metadata(host_only: bool = False) -> Dict[str, Any]:
    """The metadata block every published JSON artifact embeds.
    ``host_only=True`` skips device discovery (platform ``"unprobed"``)."""
    from trustworthy_dl_tpu_torch import __version__

    meta: Dict[str, Any] = {
        "schema": RUN_METADATA_SCHEMA,
        "python_version": sys.version.split()[0],
        "framework_version": __version__,
        "hostname": _platform.node(),
        "timestamp": time.time(),
    }
    if host_only:
        meta.update(_host_versions(), platform="unprobed",
                    device_kind="unknown", num_devices=0)
        return meta
    meta.update(_device_info())
    return meta


__all__ = ["RUN_METADATA_KEYS", "RUN_METADATA_SCHEMA", "run_metadata"]
