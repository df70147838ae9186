"""``train_step_loss`` and its gradient for every architecture, the port
against ``jax.value_and_grad(repro.models.lm.train_step_loss)``.

Each of ``configs.ARCH_NAMES`` at ``reduced()`` (float32, no remat),
the JAX ``init_lm`` weights carried across by ``lm_params_from_numpy``,
one ``TokenStream`` batch (with the front ends' ``patch_embeds`` /
``frames``); the gradients laid out in the reference's tree by
``lm_params_to_numpy(params, grads=True)``. In the port the attention's
backward is ``flash_attention_bwd``, the MoE's router gets its gradient
through the top-K weights and the load-balancing loss, the recurrences
through their scans. Then the same loss with ``remat="full"``
(``torch.utils.checkpoint`` around each layer) and ``remat="dots"``
(the products without a batch dimension saved, the rest recomputed)
gives bitwise the same gradients, and the ``dots`` gradients hold the
same tolerance against JAX's taken with ``remat="dots"``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
import repro_torch.configs as cfgs  # noqa: E402
from repro_torch.data.lm_pipeline import TokenStream  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import convert  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the reduced models' ops are tiny, and several
    test workers each spinning up every core's thread run them far
    slower."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


@pytest.mark.parametrize("arch", cfgs.ARCH_NAMES)
def test_train_step_loss_and_grads_against_jax(arch):
    """Loss within 1e-6 (relative); every gradient leaf within 1e-4 of
    its largest entry plus 1e-7 (a leaf whose gradient is zero in exact
    arithmetic, such as whisper's cross-attention key bias, holds only
    rounding noise); the tree of leaves the same."""
    jc, c = jcfgs.get(arch).reduced(), cfgs.get(arch).reduced()
    jp = jlm.init_lm(jax.random.PRNGKey(3), jc)
    b = TokenStream(c, 2, 24, seed=1).batch_at(0)
    jl, jg = jax.value_and_grad(lambda q: jlm.train_step_loss(
        q, jc, {k: jnp.asarray(v) for k, v in b.items()}))(jp)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jgd = jax.grad(lambda q: jlm.train_step_loss(
        q, jc.replace(remat="dots"),
        {k: jnp.asarray(v) for k, v in b.items()}))(jp)
    grads = []
    for remat in ("none", "full", "dots"):
        p = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                         c.replace(remat=remat),
                                         device="cpu")
        p.requires_grad_(True)
        loss = lm.train_step_loss(p, c.replace(remat=remat), tb)
        loss.backward()
        grads.append(convert.lm_params_to_numpy(p, grads=True))
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for g, jgrads in ((grads[0], jg), (grads[2], jgd)):
        got, tree = jax.tree.flatten(g)
        want, jtree = jax.tree.flatten(jax.tree.map(np.asarray, jgrads))
        assert tree == jtree
        for a, w in zip(got, want):
            assert a.shape == w.shape
            assert float(np.abs(a - w).max()) <= (
                1e-4 * float(np.abs(w).max()) + 1e-7)
    got = jax.tree.leaves(grads[0])
    for other in grads[1:]:
        for a, r in zip(got, jax.tree.leaves(other)):
            np.testing.assert_array_equal(a, r)
