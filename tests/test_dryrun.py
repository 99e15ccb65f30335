"""The driver's multi-chip artifact: ``import __graft_entry__; dryrun_multichip(8)``.

The CPU-mesh forcing must not live only under __main__: a caller that imports the module
and calls the function would otherwise initialize JAX on the accelerator.  These tests
run the entry point in fresh subprocesses the way an importing caller does, under the
hostile initialization states such a caller can produce.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env_overrides=None, timeout=600):
    """Run ``code`` in a fresh interpreter with NO test-harness JAX env leaking in."""
    env = dict(os.environ)
    # strip the conftest's CPU-mesh forcing: the entry point must do this itself
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env.pop("MLVDB_DRYRUN_CHILD", None)
    if env_overrides:
        env.update(env_overrides)
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def test_driver_style_import_and_call():
    """The exact driver sequence: import the module, call dryrun_multichip(8)."""
    proc = _run("import __graft_entry__; __graft_entry__.dryrun_multichip(8)")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "dryrun_multichip OK" in proc.stdout


def test_call_after_jax_already_initialized_single_device():
    """Driver variant: jax was imported AND initialized (1 CPU device) before the call.
    The entry point must detect the frozen backend and re-exec in a subprocess."""
    proc = _run(
        "import jax; jax.config.update('jax_platforms', 'cpu'); jax.devices(); "
        "import __graft_entry__; __graft_entry__.dryrun_multichip(8)"
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "dryrun_multichip OK" in proc.stdout


def test_main_entry():
    proc = _run("import runpy, sys; sys.argv=['__graft_entry__.py', '8']; "
                "runpy.run_path('__graft_entry__.py', run_name='__main__')")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "dryrun_multichip OK" in proc.stdout
