"""Tracing / profiling utilities — the analog of the reference's
wall-clock instrumentation (SURVEY.md §5.1).

The reference times world gen once (main.cpp:187-193) and prints a rolling
40-frame average of frame time / FPS to stdout every frame (main.cpp:204-225).
Here:

  - ``FrameStats``: the same 40-sample rolling frame-time/FPS counter, plus
    a rays/s rate (the framework's native throughput unit).
  - ``phase``: a wall-clock context manager for one-off phases (world gen,
    compile, upload); callers end device work with ``block_until_ready``
    inside the block.
  - ``trace``: ``jax.profiler`` trace scope; a profiler that cannot start
    raises.
  - device helpers for measurement entry points (``bench.py``,
    ``chip_smoke.py``): ``require_gpu`` refuses to measure anywhere but on a
    GPU, ``gpu_label`` names the card and its power limit, ``time_call``
    times compiled work to ``block_until_ready``, ``memory_summary`` condenses
    ``compiled.memory_analysis()``.
"""

from __future__ import annotations

import collections
import contextlib
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional

from .log import debug


@contextlib.contextmanager
def phase(name: str, *, level: int = 1):
    """Time a host-visible phase; prints via the leveled debug logger."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        debug(level, f"{name}: {(time.perf_counter() - t0) * 1e3:.1f} ms")


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """jax.profiler trace scope (open the result in TensorBoard/XProf).
    No-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield


class FrameStats:
    """Rolling frame statistics (the reference's 40-frame average,
    main.cpp:221-225), extended with a rays/s rate."""

    def __init__(self, window: int = 40):
        self.times = collections.deque(maxlen=window)
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self, rays: int = 0) -> float:
        """Record one frame; returns the frame time in seconds."""
        assert self._last is not None, "call start() first"
        dt = time.perf_counter() - self._last
        self._last = None
        self.times.append((dt, rays))
        return dt

    @property
    def avg_ms(self) -> float:
        if not self.times:
            return 0.0
        return 1e3 * sum(t for t, _ in self.times) / len(self.times)

    @property
    def fps(self) -> float:
        return 1e3 / self.avg_ms if self.avg_ms else 0.0

    @property
    def rays_per_s(self) -> float:
        tot_t = sum(t for t, _ in self.times)
        tot_r = sum(r for _, r in self.times)
        return tot_r / tot_t if tot_t else 0.0

    def status(self) -> str:
        return (
            f"avg frame {self.avg_ms:.1f} ms  {self.fps:.1f} fps"
            + (f"  {self.rays_per_s:.3e} rays/s" if self.rays_per_s else "")
        )


# ------------------------------------------------------------ device helpers


def device_info() -> Dict[str, object]:
    """The device as JAX reports it: platform, device_kind and count."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> Dict[str, object]:
    """``device_info()`` if JAX's default devices are GPUs; raises otherwise.
    A measurement never falls back to another platform."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device platform is {info['platform']!r}")
    return info


def gpu_label() -> str:
    """``name, power.limit`` of each card from nvidia-smi, '; '-joined. Runs
    in a child process that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(ln.strip() for ln in r.stdout.splitlines() if ln.strip())


def time_call(fn: Callable, *args, reps: int = 5) -> List[float]:
    """Seconds per call of ``fn(*args)`` for ``reps`` calls after one warm
    call; each call ends in ``block_until_ready`` on all of its outputs."""
    import jax

    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def median_ms(times: List[float]) -> float:
    return 1e3 * statistics.median(times)


def memory_summary(compiled) -> Dict[str, int]:
    """Bytes from ``compiled.memory_analysis()``: arguments, outputs, temps,
    aliased and generated code."""
    m = compiled.memory_analysis()
    return {
        "argument": int(m.argument_size_in_bytes),
        "output": int(m.output_size_in_bytes),
        "temp": int(m.temp_size_in_bytes),
        "alias": int(m.alias_size_in_bytes),
        "code": int(m.generated_code_size_in_bytes),
    }
