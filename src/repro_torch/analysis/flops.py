"""FLOP accounting of a PyTorch function, the port's ``repro/analysis/
flops.py``.

The reference walks the jaxpr of the function it lowers. The port has no
jaxpr: ``FlopCounter`` is a ``TorchDispatchMode`` that sees each ATen op
the function runs (the forward, autograd's backward and what
``torch.utils.checkpoint`` recomputes in it), on any device, ``meta``
included, where nothing is computed. The conventions are the
reference's:

* matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ...; ``einsum`` and
  ``matmul`` lower to them): ``2 * batch * M * N * K``, and ``M * N`` for
  the add of ``addmm`` / ``baddbmm`` (the reference's ``dot_general`` and
  ``add``);
* convolution: the reference's ``_conv_flops``, ``2 * out_elems *
  kernel_elems / groups``, ``kernel_elems`` every weight dim but the
  output features;
* elementwise, select and compare: 1 a output element;
* transcendentals (exp, log, tanh, sigmoid, sqrt, rsqrt, erf, sin, cos,
  pow with a non-integer exponent, ...): 1 a output element, also
  reported apart;
* reductions and cumulative ops: 1 an *input* element;
* ``sort``: ``n * log2 n`` of its input's ``n`` elements;
* data movement (views, copies, casts, gathers, pads, ``cat``,
  factories): 0.

An op that is one ATen call in PyTorch but several primitives in the
reference's jnp counts as those primitives (``_COMPOSITE``): the
softmax, for one, is ``reduce_max``, ``max``, ``sub``, ``exp``,
``reduce_sum``, ``div`` there, ``5 n + rows`` with ``n`` exponentials.
Autograd's fused backward ops count what the reference's VJP of the same
jnp function counts beyond its forward (measured with
``repro.analysis.flops.flops_of`` over ``jax.vjp``: ``silu`` 6 an
element, ``gelu`` 14, the softmax 9, ``tanh`` 4, ``sigmoid`` 3).

``ops.flash_attention`` is counted at its boundary by one formula on
every route (``attention_flops``), and the ops inside it are not: the
kernel is a ctypes launch no dispatch mode sees, and the plain version
on the CPU or ``meta`` runs ops the kernel does not. Its backward,
``flash_attention_bwd``, is PyTorch on every device and is counted op by
op.

A loop that repeats one body (the train step's microbatches) may run the
body once under ``FlopCounter.repeat(n)``, which multiplies what it
counts, as the reference multiplies a scan body by its length.
``loop_steps`` runs a model's per-step loop (the sLSTM's tokens) whole,
or, on ``meta`` under the counters, by that convention. Counts are global
(the unsharded program): divide by the device count for one device's
share.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops as kops

_ZERO_COST = {
    "view", "_unsafe_view", "_reshape_alias", "expand", "permute",
    "transpose", "t", "slice", "select", "unsqueeze", "squeeze",
    "as_strided", "alias", "detach", "lift_fresh", "lift_fresh_copy",
    "clone", "copy", "_to_copy", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "zeros", "zeros_like", "new_zeros",
    "ones", "ones_like", "new_ones", "full", "full_like", "new_full",
    "fill", "zero", "scalar_tensor", "arange", "cat", "stack", "split",
    "split_with_sizes", "unbind", "narrow", "index", "_unsafe_index",
    "index_select", "gather", "embedding", "constant_pad_nd", "flip",
    "roll", "repeat", "unfold", "diagonal", "slice_scatter",
    "select_scatter", "slice_backward", "select_backward",
}

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sin",
    "cos", "erf", "erfc", "sigmoid", "rsqrt", "sqrt", "pow", "atan2",
    "lgamma", "digamma",
}

# reductions and cumulative ops, 1 an input element (``mean`` adds its
# division, 1 an output element)
_REDUCERS = {
    "sum", "nansum", "amax", "amin", "argmax", "argmin", "prod", "any",
    "all", "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "linalg_vector_norm", "norm", "count_nonzero",
}

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot"}

# one ATen op, several primitives in the reference: (flops an element,
# flops a row, transcendentals an element, transcendentals a row) over the
# first input's elements and the output's rows (its element count when it
# is reduced, ``n / size(dim)`` when it is not)
_COMPOSITE = {
    "_softmax": (5, 1, 1, 0),
    "_log_softmax": (5, 2, 1, 1),
    "logsumexp": (4, 7, 1, 1),
    "var": (4, 4, 0, 0),
    "silu": (2, 0, 1, 0),
    "gelu": (8, 0, 1, 0),  # the tanh form; the exact one: _GELU_EXACT
    # backward ops: the reference's VJP beyond its forward
    "_softmax_backward_data": (9, 0, 0, 0),
    "_log_softmax_backward_data": (4, 0, 0, 0),
    "silu_backward": (6, 0, 0, 0),
    "gelu_backward": (14, 0, 0, 0),
    "tanh_backward": (4, 0, 0, 0),
    "sigmoid_backward": (3, 0, 0, 0),
}
_GELU_EXACT = {"gelu": (5, 0, 1, 0), "gelu_backward": (11, 0, 1, 0)}

# the reference's chunked attention's blocks (``repro/kernels/ref.py::
# chunked_attention``) and its route's threshold (``kops``'s)
ATTN_BLOCK = 1024


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _outputs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


def _product_flops(name: str, args) -> float:
    """``2 * batch * M * N * K`` of a matmul op: ``a (..., M, K)`` or
    ``(K,)`` against ``b (..., K, N)`` or ``(K,)`` (the ``add*`` forms
    take a bias first)."""
    a, b = args[-2:] if name.startswith("add") else args[:2]
    return 2.0 * a.numel() * (b.shape[-1] if b.dim() >= 2 else 1)


def _conv_flops(out, weight, groups: int) -> float:
    """The reference's ``_conv_flops``: ``2 * out_elems * kernel_elems /
    groups`` with ``kernel_elems`` every weight dim but the output
    features (torch's ``(out, in / groups, *k)``)."""
    return 2.0 * out.numel() * math.prod(weight.shape[1:]) / max(groups, 1)


def _integral(x) -> bool:
    return isinstance(x, int) or (isinstance(x, float) and x.is_integer())


def attention_flops(B: int, Sq: int, Skv: int, H: int, D: int, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    softcap: float | None = None,
                    dense_limit: int = kops._DENSE_SCORE_LIMIT,
                    block: int = ATTN_BLOCK) -> dict:
    """What the reference's ``flops_of`` counts for its plain attention
    at this shape, the route it takes off the TPU: dense when ``Sq * Skv
    <= dense_limit``, else chunked. ``{"flops", "transcendental",
    "matmul"}``.

    Both versions compute the full ``Sq x Skv`` products (the mask drops
    nothing from the work; the chunked one scans every key block of every
    query block). With ``N = B H Sq Skv`` scores and ``R = B H Sq`` rows,
    the dense version (``ref.flash_attention``) counts:

    * the two products, ``4 N D`` (GQA's ``repeat`` is data movement);
    * the scale's multiply, ``N``, and with ``scale=None`` its
      computation, ``sqrt`` and ``div`` of one element (2, one
      transcendental); the softcap's ``div``, ``tanh``, ``mul``, ``3 N``
      (``N`` transcendental);
    * the mask: the query positions' add, ``Sq``; causal ``le`` and
      ``and`` over ``Sq Skv``, ``2 Sq Skv``; a window its ``sub`` of
      ``Sq``, ``gt`` and ``and``, ``Sq + 2 Sq Skv``;
    * the ``where``, ``N``; the softmax, ``5 N + R`` (``N`` exps).

    The chunked version (``ref.chunked_attention``) pads ``Sq`` and
    ``Skv`` to ``block`` multiples, ``nq x nk`` blocks of ``n = B H
    block^2`` scores and ``r = B H block`` rows; a query block counts
    ``1 + 2 block`` (its positions), ``r + r D`` (the final ``max`` and
    ``div``) and, each key block, ``4 n D`` (products), ``6 n`` (scale,
    ``where``, max, ``sub``, ``exp``, sum), ``5 r`` (the running max, its
    correction's ``sub`` and ``exp``, the denominator's ``mul`` and
    ``add``), ``2 r D`` (the accumulator's ``mul`` and ``add``), ``1 + 2
    block`` (the key positions and their bound) and the mask's ``2
    block^2`` (causal) and ``block + 2 block^2`` (window); the softcap adds
    ``3 n``. Exponentials: ``n + r`` a key block, ``n`` more with the
    softcap. ``tests/test_torch_dryrun.py`` holds both forms to
    ``flops_of`` of the reference's versions."""
    if Sq * Skv <= dense_limit:
        N, R = B * H * Sq * Skv, B * H * Sq
        mm = 4.0 * N * D
        flops = mm + N + N + 5 * N + R + Sq
        tr = N
        if scale is None:
            flops, tr = flops + 2, tr + 1
        if softcap:
            flops, tr = flops + 3 * N, tr + N
        if causal:
            flops += 2 * Sq * Skv
        if window:
            flops += Sq + 2 * Sq * Skv
        return {"flops": float(flops), "transcendental": float(tr),
                "matmul": mm}
    nq, nk = -(-Sq // block), -(-Skv // block)
    n, r = B * H * block * block, B * H * block
    per_k = 4 * n * D + 6 * n + 5 * r + 2 * r * D + 1 + 2 * block
    tr_k = n + r
    if softcap:
        per_k, tr_k = per_k + 3 * n, tr_k + n
    if causal:
        per_k += 2 * block * block
    if window:
        per_k += block + 2 * block * block
    per_q = 1 + 2 * block + r + r * D + nk * per_k
    return {"flops": float(nq * per_q), "transcendental": float(nq * nk * tr_k),
            "matmul": float(nq * nk * 4 * n * D)}


def _key(x, devs: set):
    """A hashable description of an op argument, a tensor by its shape,
    strides and dtype; each tensor's device type goes into ``devs``."""
    if isinstance(x, torch.Tensor):
        devs.add(x.device.type)
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(y, devs) for y in x)
    return x


def _memo_kind(func) -> str | None:
    """``"functional"`` (returns fresh tensors), ``"inplace"`` (writes and
    returns its first argument) or None (a view, or anything else)."""
    schema = func._schema
    rets = schema.returns
    if not schema.is_mutable and all(r.alias_info is None for r in rets):
        return "functional"
    if (len(rets) == 1 and rets[0].alias_info is not None
            and rets[0].alias_info.is_write
            and schema.arguments[0].alias_info is not None):
        return "inplace"
    return None


class _MetaMemo:
    """Runs ops, serving a repeat of a non-view op on ``meta`` tensors from
    a memo. PyTorch's ``meta`` kernels of many ops are Python (up to ~1 ms
    a call), and a full-depth step repeats each op at the same shapes per
    layer, per microbatch and per recurrence step (the sLSTM's 32,768 at
    prefill_32k): the first call runs the op's own meta kernel, a repeat
    gets fresh empty tensors of its outputs' shapes, strides and dtypes
    (a functional op), or its ``self`` (an in-place op). Views, and ops on
    any other device, always run; with ``fresh_only`` (a census, which
    follows storages) so does an op whose first call returned a storage
    of its arguments (``_unsafe_view``)."""

    def __init__(self, fresh_only: bool = False):
        self._memo: dict = {}
        self._kinds: dict = {}
        self._fresh_only = fresh_only

    def run(self, func, args, kwargs):
        kind = self._kinds.get(func, 0)
        if kind == 0:
            kind = self._kinds[func] = _memo_kind(func)
        if kind is None:
            return func(*args, **kwargs)
        devs: set = set()
        try:
            key = (func, _key(args, devs),
                   _key(tuple(sorted(kwargs.items())), devs))
            hit = self._memo.get(key)
        except TypeError:  # an unhashable argument
            return func(*args, **kwargs)
        if devs != {"meta"} or hit is False:
            return func(*args, **kwargs)
        if hit is not None:
            if kind == "inplace":
                return args[0]
            made = [torch.empty_strided(shape, stride, dtype=dt,
                                        device="meta")
                    for shape, stride, dt in hit[1]]
            return made[0] if hit[0] is None else hit[0](made)
        out = func(*args, **kwargs)
        outs = _outputs(out)
        if self._fresh_only and kind == "functional" and {
                t.untyped_storage()._cdata for t in outs} & {
                t.untyped_storage()._cdata
                for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)}:
            self._memo[key] = False
            return out
        if isinstance(out, torch.Tensor):
            form = None
        elif isinstance(out, (tuple, list)) and len(outs) == len(out):
            form = type(out)
        else:
            return out
        self._memo[key] = (form, [(tuple(t.shape), t.stride(), t.dtype)
                                  for t in outs])
        return out


class FlopCounter(TorchDispatchMode):
    """Counts the ATen ops run inside ``with counter:`` by the module's
    conventions: ``flops``, ``transcendental``, ``matmul`` (the products'
    share of ``flops``) and ``by_op`` (flops by op name)."""

    counts_attention = True  # ``kops.attention_observers()`` finds it

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.transcendental = 0.0
        self.matmul = 0.0
        self.by_op: dict[str, float] = {}
        self._mult = 1.0
        self._quiet = 0
        self._meta = _MetaMemo()

    def result(self) -> dict:
        """``{"flops", "transcendental"}``, the reference's ``flops_of``
        keys."""
        return {"flops": self.flops, "transcendental": self.transcendental}

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Multiply what is counted inside by ``n``: the one run of a body
        that a loop repeats ``n`` times."""
        self._mult *= n
        try:
            yield
        finally:
            self._mult /= n

    @contextlib.contextmanager
    def attention(self, q, k, v, *, causal=True, window=None, scale=None,
                  softcap=None):
        """``ops.flash_attention``'s boundary: add ``attention_flops`` at
        ``q (B, Sq, H, D)``, ``k (B, Skv, Hkv, D)`` and count nothing run
        inside."""
        B, Sq, H, D = q.shape
        c = attention_flops(B, Sq, k.shape[1], H, D, causal=causal,
                            window=window, scale=scale, softcap=softcap)
        self._add("flash_attention", c["flops"], c["transcendental"],
                  c["matmul"])
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def _add(self, name: str, flops: float, tr: float = 0.0,
             mm: float = 0.0) -> None:
        m = self._mult
        self.flops += m * flops
        self.transcendental += m * tr
        self.matmul += m * mm
        self.by_op[name] = self.by_op.get(name, 0.0) + m * flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._meta.run(func, args, kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        base = name[:-1] if name.endswith("_") else name  # in place
        if base in _ZERO_COST:
            return
        outs = _outputs(out)
        n_out = sum(t.numel() for t in outs)
        if base in _MATMUL:
            prod = _product_flops(base, args)
            add = n_out if base.startswith("add") else 0
            self._add(base, prod + add, mm=prod)
            return
        if base == "convolution":
            self._add(base, _conv_flops(outs[0], args[1], args[8]))
            return
        if base == "convolution_backward":
            mask = args[10] if len(args) > 10 else kwargs["output_mask"]
            fwd = _conv_flops(args[0], args[2], args[9])
            self._add(base, fwd * sum(bool(m) for m in mask[:2]))
            return
        if base == "sort":
            n = _numel(args[0])
            self._add(base, n * max(math.log2(max(n, 2)), 1.0))
            return
        if base in _COMPOSITE:
            exact = kwargs.get("approximate", "none") == "none"
            table = _GELU_EXACT if base in _GELU_EXACT and exact \
                else _COMPOSITE
            fe, fr, te, tr_ = table[base]
            n = _numel(args[0])
            rows = (n // args[0].shape[args[1]]
                    if base in ("_softmax", "_log_softmax") else n_out)
            self._add(base, fe * n + fr * rows, te * n + tr_ * rows)
            return
        if base == "mean":
            self._add(base, _numel(args[0]) + n_out)
            return
        if base in _REDUCERS or (base in ("max", "min") and
                                 func._overloadname != "other"):
            self._add(base, _numel(args[0]))
            return
        if base == "pow" and func._overloadname == "Tensor_Scalar" \
                and _integral(args[1]):
            self._add(base, n_out)  # the reference's integer_pow
            return
        if base in _TRANSCENDENTAL:
            self._add(base, n_out, n_out)
            return
        self._add(base, n_out)


def loop_steps(step, xs, carry: tuple, emit: int):
    """``carry = step(x_t, carry)`` for each step ``x_t`` of ``xs`` along
    dimension 1; returns ``(ys, carry)``, ``ys`` every step's
    ``carry[emit]`` stacked along dimension 1.

    The loop runs whole, unless ``xs`` is on ``meta`` under counters that
    repeat (``FlopCounter``, ``analysis.census.Census``) and has three
    steps or more. Then it is counted as the reference counts a while
    loop, its body times its trip count: the first step, one middle step
    counted ``S - 2`` times, the last step (the first and last differ from
    the rest in their backward: no gradient of a zero initial state, none
    of the final one). The middle step's backward runs between a hook on
    its outputs and a hook on the first step's, and is counted ``S - 2``
    times too: the graph's nodes run in reverse order of creation, so
    nothing else runs there (an output stacked into ``ys`` is a carry, so
    its gradient is whole only once the last step's backward ran). Traffic,
    op counts, FLOPs and collectives equal the whole loop's; storages count
    once, so its temporaries are the three steps'."""
    S = xs.shape[1]
    counters = _loop_counters(xs, S)
    if counters:
        return _counted_steps(step, xs, carry, emit, counters)
    ys = []
    # one view a step whose gradients stack once (indexing xs[:, t] would
    # add S full-size zero-padded gradients)
    for x_t in xs.unbind(1):
        carry = step(x_t, carry)
        ys.append(carry[emit])
    return torch.stack(ys, dim=1), carry


def _loop_counters(t, n: int) -> list:
    """The active counters that may count a loop of ``n`` identical steps
    over ``t`` by one body: none (the loop runs whole) off ``meta``, where
    values matter, or for ``n < 3``."""
    if n < 3 or t.device.type != "meta":
        return []
    return [m for m in kops.attention_observers() if hasattr(m, "repeat")]


def _repeat(counters: list, n: int) -> contextlib.ExitStack:
    """Every counter of ``counters`` multiplying what it counts by ``n``
    (entered; ``close()`` leaves)."""
    stack = contextlib.ExitStack()
    for c in counters:
        stack.enter_context(c.repeat(n))
    return stack


class _Ends(torch.autograd.Function):
    """``xs (B, S, ...)``'s steps ``0``, ``1`` and ``S - 1``, as views; the
    gradient is the one ``stack`` of every step's that ``unbind``'s
    backward makes, step 1's standing for steps ``1 .. S - 2``."""

    @staticmethod
    def forward(ctx, xs):
        ctx.S = S = xs.shape[1]
        return xs.select(1, 0), xs.select(1, 1), xs.select(1, S - 1)

    @staticmethod
    def backward(ctx, g0, g1, gl):
        return torch.stack([g0] + [g1] * (ctx.S - 2) + [gl], dim=1)


def _counted_steps(step, xs, carry: tuple, emit: int, counters: list):
    """``loop_steps`` by its first, one middle and its last step."""
    S = xs.shape[1]
    x0, x1, xl = _Ends.apply(xs) if (
        torch.is_grad_enabled() and xs.requires_grad) else (
        xs.select(1, 0), xs.select(1, 1), xs.select(1, S - 1))
    first = step(x0, carry)
    with _repeat(counters, S - 2):
        mid = step(x1, first)
    if torch.is_grad_enabled():
        window = []

        def enter(_):
            if not window:
                window.append(_repeat(counters, S - 2))

        def leave(_):
            if window and window[0] is not None:
                window[0].close()
                window[0] = None

        for t in mid:
            if t.requires_grad:
                t.register_hook(enter)
        for t in first:
            if t.requires_grad:
                t.register_hook(leave)
    last = step(xl, mid)
    ys = ([first[emit], mid[emit]] + [mid[emit].detach()] * (S - 3)
          + [last[emit]])
    return torch.stack(ys, dim=1), last


def flops_of(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under a ``FlopCounter`` and return its
    ``{"flops", "transcendental"}``. On ``meta`` tensors nothing is
    computed."""
    with FlopCounter() as c:
        fn(*args, **kwargs)
    return c.result()


__all__ = ["FlopCounter", "flops_of", "attention_flops", "ATTN_BLOCK",
           "loop_steps"]
