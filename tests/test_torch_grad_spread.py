"""``launch.grad_spread``: the first step's gradients under several
summation orders, leaf by leaf, on the CPU at reduced size."""
import argparse

import pytest

pytest.importorskip("torch")

from repro_torch.launch import grad_spread as gs  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    args = argparse.Namespace(arch="xlstm-125m", reduced=True, layers=None,
                              batch=4, seq_len=64, seed=0,
                              float32=False)
    tmp = str(tmp_path_factory.mktemp("grad_spread"))
    return {spec: gs.run(args, spec, tmp) for spec in ("1", "2", "1x2")}


def test_one_order_twice_is_bitwise(runs):
    """One process at 1 and at 2 threads: at this size the same sums, so
    every gap and flip is 0 (the tool reads rounding, not noise of its
    own)."""
    for n, gap, flips in gs.spread(runs["1"], runs["2"]).values():
        assert n > 0 and gap == 0.0 and flips == 0.0
    assert float(runs["1"]["__loss"]) == float(runs["2"]["__loss"])


def test_sharded_gradients_match_one_process(runs):
    """The (1, 2) gloo mesh's whole gradients against one process's: every
    leaf the plain trainer has, each within bf16 rounding (a relative L2
    gap under 1e-2), few first updates flipped, the loss within 1e-5."""
    got = gs.spread(runs["1"], runs["1x2"])
    assert {"embed", "lm_head", "block.wq", "block.w_zifo"} <= set(got)
    for leaf, (n, gap, flips) in got.items():
        assert gap < 1e-2 and flips < 1e-2, (leaf, gap, flips)
    one, sharded = float(runs["1"]["__loss"]), float(runs["1x2"]["__loss"])
    assert abs(sharded - one) <= 1e-5 * abs(one)
    assert gs.grad_norm(runs["1x2"]) == pytest.approx(
        gs.grad_norm(runs["1"]), rel=1e-2)


def test_float32_option_keeps_an_f32_config(runs, tmp_path):
    """``--float32``: the reduced config is f32 already, so the option
    changes nothing there, bitwise."""
    args = argparse.Namespace(arch="xlstm-125m", reduced=True, layers=None,
                              batch=4, seq_len=64, seed=0, float32=True)
    got = gs.run(args, "1", str(tmp_path))
    for n, gap, flips in gs.spread(runs["1"], got).values():
        assert gap == 0.0 and flips == 0.0
