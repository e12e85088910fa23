"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices, so multi-device
sharding logic is exercised without accelerators, unless JAX_PLATFORMS names
another platform. Tests that need a GPU carry the ``gpu`` marker and skip
elsewhere; chip_smoke.py runs them on the card.
"""

import os

import pytest

_cpu = os.environ.get("JAX_PLATFORMS", "cpu").split(",")[0] == "cpu"
if _cpu:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if _cpu:
    jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_enable_x64", True)


# --- auto-retry tests whose xdist WORKER crashed -------------------------
#
# XLA:CPU's compiler has segfaulted flakily deep into long processes,
# taking whichever test a worker was compiling down with it ("[gwN] node
# down"); the test passes standalone. Reschedule a crashed item ONCE on a
# fresh worker; a test that crashes twice is a real failure and reports
# normally.

_crash_retried: set = set()


@pytest.hookimpl(optionalhook=True)
def pytest_handlecrashitem(crashitem, report, sched):
    """xdist hook: called on the controller when a worker crashes."""
    if crashitem not in _crash_retried:
        _crash_retried.add(crashitem)
        sched.mark_test_pending(crashitem)
        report.outcome = "rerun"  # suppress the failure report
