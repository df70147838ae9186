"""Crash recovery of the port end to end: a serving child process is
SIGKILLed inside a save, a second process restores from the store, and
its continuation lands leaf for leaf on an uninterrupted run.

The crash child's store carries an injected ``store.commit`` delay (the
window before the COMMITTED marker, held open for the kill), so the
interrupted snapshot never commits: the restart comes up from the earlier
committed step, replays the remaining chunks and must equal the oracle,
in both engines. (One device: the port has no tenant sharding.)
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

pytest.importorskip("torch")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import sys, time
    import numpy as np, torch
    mode, root, out, role = sys.argv[1:5]
    from repro_torch.regression import RegressionServingEngine
    from repro_torch.robustness import Fault, FaultInjector, FaultPlan
    from repro_torch.serving import (AsyncShardedSaver, ServingEngine,
                                     SessionStore)

    S, T, CH, CAP, WIN, DIM, K = 8, 24, 6, 16, 8, 3, 3

    def mk():
        kw = dict(n_sessions=S, capacity=CAP, dim=DIM, k=K, window=WIN,
                  device="cpu")
        if mode == "classification":
            return ServingEngine(n_labels=2, **kw)
        return RegressionServingEngine(**kw)

    rng = np.random.default_rng(0)
    X = rng.normal(size=(T, S, DIM)).astype(np.float32)
    if mode == "classification":
        y = rng.integers(0, 2, size=(T, S)).astype(np.int32)
    else:
        y = rng.normal(size=(T, S)).astype(np.float32)
    taus = rng.uniform(size=(T, S)).astype(np.float32)

    def run_chunk(eng, state, c):
        sl = slice(c * CH, (c + 1) * CH)
        return eng.observe_many(state, X[sl], y[sl], taus[sl])

    def dump(state):
        np.savez(out, **{f"leaf{i}": t.numpy()
                         for i, t in enumerate(state.leaves())})

    if role == "resume":
        eng, state, step = SessionStore(root).restore_engine(device="cpu")
        print(f"resumed_from {step}", flush=True)
        for c in range(step + 1, T // CH):
            state, _ = run_chunk(eng, state, c)
        dump(state)
        print("done", flush=True)
        sys.exit(0)

    injector = None
    if role == "crash":
        # hold step 2's commit window open: the parent's SIGKILL lands
        # inside the save, so step 2 never commits
        injector = FaultInjector(FaultPlan(0, (
            Fault("store.commit", 2, "delay", param=120.0),)))
    store = SessionStore(root, injector=injector)
    saver = AsyncShardedSaver(store, 1, seed=0)
    eng = mk()
    state = eng.init_state()
    for c in range(T // CH):
        state, _ = run_chunk(eng, state, c)
        if c == 0:
            saver.save(0, state, meta=eng.meta())
            saver.wait()  # the committed step before the crash window
            print("baseline_committed", flush=True)
        if c == 2 and role == "crash":
            saver.save(2, state, meta=eng.meta())
            print("save_enqueued 2", flush=True)
            time.sleep(300)  # killed by the parent inside the save
    saver.close()
    dump(state)
    print("done", flush=True)
""")


def _env():
    env = dict(os.environ)
    src = os.path.join(_REPO, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _wait_for(proc, needle, timeout=300):
    deadline = time.time() + timeout
    seen = []
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        if needle in line:
            return seen
    raise AssertionError(
        f"child never printed {needle!r}; got: {''.join(seen)}")


@pytest.mark.parametrize("mode", ["classification", "regression"])
def test_sigkill_inside_a_save_then_bitwise_continuation(tmp_path, mode):
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    root = str(tmp_path / "store")
    resume_out = str(tmp_path / "resume.npz")
    oracle_out = str(tmp_path / "oracle.npz")

    def cmd(role, out, store_root):
        return [sys.executable, str(script), mode, store_root, out, role]

    proc = subprocess.Popen(cmd("crash", str(tmp_path / "crash.npz"), root),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=_env())
    try:
        seen = _wait_for(proc, "save_enqueued 2")
        assert any("baseline_committed" in ln for ln in seen)
        # the worker reaches the held-open commit once step 2's tmp
        # directory holds its manifest
        manifest = os.path.join(root, f"step_{2:09d}.tmp", "manifest.json")
        deadline = time.time() + 60
        while not os.path.exists(manifest) and time.time() < deadline:
            time.sleep(0.05)
        assert os.path.exists(manifest)
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.stdout.close()
        proc.wait(timeout=60)

    assert not os.path.exists(
        os.path.join(root, f"step_{2:09d}", "COMMITTED"))

    r = subprocess.run(cmd("resume", resume_out, root), capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "resumed_from 0" in r.stdout, r.stdout

    r = subprocess.run(cmd("oracle", oracle_out, str(tmp_path / "store2")),
                       capture_output=True, text=True, env=_env(),
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr

    got, want = np.load(resume_out), np.load(oracle_out)
    assert sorted(got.files) == sorted(want.files)
    for name in want.files:
        assert got[name].tobytes() == want[name].tobytes(), \
            f"{name} diverged after crash recovery"
