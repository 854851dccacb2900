"""Where the program runs: backend, kernel route, interpret mode, compile
cache and the device's identity — decided here and nowhere else.

- Pallas kernels compile through Triton (``PALLAS_BACKEND``) and name the
  route in every ``pallas_call``: a GPU ``pallas_call`` that names none
  goes to Mosaic GPU in the installed JAX.
- Interpret mode runs only after an explicit ``allow_interpret()`` (the
  test suite and the CPU rehearsal of ``chip_smoke.py``).  On a GPU a
  kernel never runs interpreted; on a CPU where nobody allowed it,
  ``interpret()`` raises instead of silently running the interpreter.
- The persistent compile cache lives where ``JAX_COMPILATION_CACHE_DIR``
  says, or else at one fixed path inside the checkout.
- The device's identity (platform, kind, count, and the ``nvidia-smi``
  name and power limit) is recorded beside every number.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
from typing import Optional

import jax

PALLAS_BACKEND = "triton"

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")

_interpret_allowed = False


def allow_interpret() -> None:
    """Let Pallas kernels run in interpret mode on a CPU backend."""
    global _interpret_allowed
    _interpret_allowed = True


def interpret() -> bool:
    """The ``interpret=`` every ``pallas_call`` passes.

    False on a GPU.  On a CPU backend, True only after allow_interpret();
    otherwise raises, so no caller measures the interpreter by mistake."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if _interpret_allowed:
        return True
    raise RuntimeError(
        f"Pallas kernels compile for the GPU only; the backend is "
        f"{backend!r} and interpret mode was not allowed "
        f"(spgrid.core.platform.allow_interpret())")


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at its one directory.

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; only when it is unset
    is the fixed in-checkout path set here.  A fixed path matters: the
    directory is part of the cache key, so a moving path never hits."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def nvidia_smi() -> Optional[str]:
    """``name, power.limit`` of the first GPU as nvidia-smi prints them, or
    None where there is no nvidia-smi.  A child process that never imports
    JAX, so it holds no device memory."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


@dataclasses.dataclass(frozen=True)
class DeviceIdentity:
    platform: str          # jax.devices()[0].platform
    kind: str              # jax.devices()[0].device_kind
    count: int             # len(jax.devices())
    smi: Optional[str]     # "name, power.limit" from nvidia-smi, or None

    @property
    def label(self) -> str:
        """One CSV-safe cell: the kind, and the power limit where the card
        reports one (a card set below its maximum runs slower)."""
        if not self.smi:
            return self.kind
        power = self.smi.split(",")[-1].strip()
        return f"{self.kind} {power}"

    def as_dict(self) -> dict:
        return {"platform": self.platform, "kind": self.kind,
                "count": self.count}


@functools.cache
def device_identity() -> DeviceIdentity:
    """The identity of this process's devices (fixed for its lifetime)."""
    devs = jax.devices()
    smi = nvidia_smi() if devs[0].platform == "gpu" else None
    return DeviceIdentity(platform=devs[0].platform,
                          kind=devs[0].device_kind, count=len(devs), smi=smi)
