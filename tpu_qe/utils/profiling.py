"""Tracing & profiling subsystem.

The equivalent of the reference's profiling hooks (SURVEY.md §5):
- device.start_capture()/stop_capture() frame captures for NSight
  (/root/reference/src/main.rs:718,729)  ->  jax.profiler trace sessions
- insert_debug_marker per compute pass (main.rs:588,601,611,630,644,662)
  ->  jax.named_scope / jax.profiler.TraceAnnotation around each kernel
- the windowed mode that exists only so NSight attaches (README.md:5-7)
  ->  not needed: traces are written to disk and viewed in TensorBoard/XProf
"""

from __future__ import annotations

import contextlib
import logging

import jax

log = logging.getLogger("tpu_qe")


@contextlib.contextmanager
def trace_session(trace_dir: str | None):
    """Profiler capture scope (start_capture/stop_capture analogue).

    Writes an XProf/TensorBoard trace under trace_dir; no-op when None.
    """
    if not trace_dir:
        yield
        return
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", trace_dir)


def marker(name: str):
    """Named scope for a pipeline stage — the insert_debug_marker analogue.

    Usage: `with marker("histogram pass"): ...` around kernel dispatches;
    the name shows up in XProf timelines and HLO metadata.
    """
    return jax.named_scope(name)
