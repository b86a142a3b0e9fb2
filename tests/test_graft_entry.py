"""Driver-contract tests for ``__graft_entry__``.

``dryrun_multichip`` runs on whatever backend the caller configured; the
fresh-interpreter check pins a CPU-only process with eight virtual devices
through the environment, exactly as a caller without cards would.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_fresh_subprocess():
    """Fresh interpreter, no conftest: the CPU backend and its device count
    come from the environment."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_NUM_CPU_DEVICES"] = "8"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache"))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__; __graft_entry__.dryrun_multichip(8)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, (
        f"dryrun_multichip(8) failed in fresh subprocess\n"
        f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-2000:]}"
    )
    assert "dryrun_multichip OK" in proc.stdout


def test_dryrun_multichip_inprocess_backend_already_up():
    """With the backend already initialized by the pytest conftest, the
    dryrun runs on the pre-configured 8-device CPU mesh."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_entry_compiles_and_runs():
    import jax

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert out.x.shape == (4096,)
