"""``attn_compute_dtype``: the port's ``"bf16_accum32"`` against the
reference's, and ``"f32"`` as it was.

``"bf16_accum32"`` keeps the operands in their storage dtype and forms the
scores and the output in f32 (``models.attention.f32_product``: exact
products summed in f32, the reference's ``preferred_element_type``).

* ``_sdpa`` at a causal GQA shape (2 x 1024, 8 q / 2 kv heads, hd 128, q
  and k ~ N(0, 4)) and a sliding-window one, bf16 inputs from a numpy
  seed: the largest gap to the reference's ``_sdpa`` at most BF16_TOL,
  and at the causal shape at most twice the ``"f32"`` mode's gap on the
  same inputs.
* ``"f32"``: the outputs bit for bit those of the formula it had
  (``_f32_before``).
* The gradients of ``_sdpa`` in ``"bf16_accum32"`` against ``jax.grad`` of
  the reference's, and a train step of a reduced bf16 OLMoE whose
  backward runs through ``f32_product`` in every layer.
* ``f32_product``'s routes (CPU: f32 copies; ``meta``: ``bmm``'s
  ``out_dtype`` form, differentiable), and its FLOPs counted
  (``analysis.counters``).

The sequence-sharded decode in ``"bf16_accum32"`` runs in the four-rank
gloo world of ``test_torch_tp.py`` (``_torch_tp_ranks.attn_decode``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402

#: the largest gap of ``_sdpa``'s output to the reference's at these
#: shapes: the reference's own bf16-vs-f32 gap on the causal case's
#: inputs is 0.0156 (one bf16 ulp of the outputs' largest magnitudes)
BF16_TOL = 0.016
#: (rows, S, q heads, kv heads, hd, window, q / k scale)
CASES = {"causal": (2, 1024, 8, 2, 128, None, 2.0),
         "window": (2, 256, 6, 2, 64, 48, 2.0)}
#: the gradient case, and its tolerance of each gradient's largest entry:
#: a few bf16 ulps (the reference rounds the probabilities' cotangent to
#: bf16 and back, the port keeps it f32; 0.0054 at the seed)
GRAD_CASE = (2, 64, 4, 2, 32, None, 2.0)
GRAD_TOL = 1e-2
SEED = 0


def _inputs(case, seed=SEED):
    """q, k, v (f32 numpy, each a bf16 value) and the positions [B, S]."""
    b, s, hq, hkv, hd, _, sc = case
    rng = np.random.default_rng(seed)

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).bfloat16().float() \
            .numpy()
    q = bf16(rng.standard_normal((b, s, hq, hd)) * sc)
    k = bf16(rng.standard_normal((b, s, hkv, hd)) * sc)
    v = bf16(rng.standard_normal((b, s, hkv, hd)))
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    return q, k, v, pos


def _jax_sdpa(case, q, k, v, pos, mode):
    import jax.numpy as jnp
    from repro.models.attention import _mask_bias, _sdpa
    bias = _mask_bias(jnp.asarray(pos), jnp.asarray(pos), case[5], True)
    return _sdpa(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), bias,
                 case[4] ** -0.5, mode)


@pytest.fixture(scope="module")
def oracle():
    """The reference's outputs of every case in both modes, and its
    gradients of ``GRAD_CASE`` (of sum(out * w), w from the seed)."""
    import jax
    import jax.numpy as jnp
    out = {}
    for name, case in CASES.items():
        x = _inputs(case)
        out[name] = {mode: np.asarray(_jax_sdpa(case, *x, mode)
                                      .astype(jnp.float32))
                     for mode in ("f32", "bf16_accum32")}
    q, k, v, pos = _inputs(GRAD_CASE)
    w = _cotangent(GRAD_CASE)

    def loss(q, k, v):
        o = _jax_sdpa(GRAD_CASE, q, k, v, pos, "bf16_accum32")
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    out["grads"] = [np.asarray(g.astype(jnp.float32)) for g in grads]
    return out


def _cotangent(case):
    b, s, hq, _, hd, _, _ = case
    return np.random.default_rng(SEED + 1).standard_normal(
        (b, s, hq, hd)).astype(np.float32)


def _port(case, mode, requires_grad=False):
    """(out, (q, k, v)) of the port's ``_sdpa`` on ``case``'s inputs as
    bf16 tensors."""
    from repro_torch.models.attention import _mask_bias, _sdpa
    q, k, v, pos = _inputs(case)
    qkv = [torch.from_numpy(x).bfloat16().requires_grad_(requires_grad)
           for x in (q, k, v)]
    p = torch.from_numpy(pos)
    bias = _mask_bias(p, p, case[5], True)
    return _sdpa(*qkv, bias, case[4] ** -0.5, mode), qkv


def _f32_before(q, k, v, bias, scale):
    """``_sdpa``'s ``"f32"`` formula as it stood before ``"bf16_accum32"``
    had its own products."""
    b, sq, hq, dq = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dq)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores * scale + bias[:, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


@pytest.mark.parametrize("name", list(CASES))
def test_sdpa_bf16_accum32_matches_reference(oracle, name):
    """C11: f32 scores from bf16 operands; before, the port rounded every
    score to bf16 (0.085 at the causal case).  At the causal case the gap
    is also at most twice the ``"f32"`` mode's; at the window case the
    ``"f32"`` outputs differ only where they are small (0.00012), while
    ``"bf16_accum32"`` rounds a probability to the other bf16 neighbour
    here and there (one bf16 ulp of an output near 1, as the causal
    case's ``"f32"`` gap)."""
    with torch.no_grad():
        got = {mode: _port(CASES[name], mode)[0].float().numpy()
               for mode in ("f32", "bf16_accum32")}
    gap = {mode: np.abs(got[mode] - oracle[name][mode]).max()
           for mode in got}
    assert gap["bf16_accum32"] <= BF16_TOL, gap
    if name == "causal":
        assert gap["bf16_accum32"] <= 2 * gap["f32"], gap


@pytest.mark.parametrize("name", list(CASES))
def test_sdpa_f32_is_unchanged(name):
    from repro_torch.models.attention import _mask_bias
    case = CASES[name]
    q, k, v, pos = _inputs(case)
    qkv = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    p = torch.from_numpy(pos)
    with torch.no_grad():
        got, _ = _port(case, "f32")
        want = _f32_before(*qkv, _mask_bias(p, p, case[5], True),
                           case[4] ** -0.5)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_sdpa_bf16_accum32_grads_match_reference(oracle):
    """The backward of ``_ScoresF32`` / ``_ValuesF32`` against the
    reference's transpose of ``preferred_element_type`` (which also rounds
    the probabilities' cotangent to bf16 and back; the port keeps it f32)."""
    out, qkv = _port(GRAD_CASE, "bf16_accum32", requires_grad=True)
    (out.float() * torch.from_numpy(_cotangent(GRAD_CASE))).sum().backward()
    for t, want in zip(qkv, oracle["grads"]):
        assert t.grad.dtype == torch.bfloat16
        got = t.grad.float().numpy()
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale)


def test_train_step_differentiates_through_bf16_accum32(monkeypatch):
    """A train step of a reduced bf16 OLMoE in ``"bf16_accum32"``: every
    layer's two products run forward and their four backward through
    ``f32_product``, the loss and every gradient finite, and the loss
    within 1e-2 of the ``"f32"`` mode's."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models.opts import ModelOpts
    from repro_torch.training import value_and_grad
    from repro_torch.tree import leaves
    cfg = get_config("olmoe-1b-7b").reduced().with_(dtype="bfloat16")
    params = models.init_params(cfg, 0, device="cpu")
    batch = models.make_train_batch(cfg, torch.Generator().manual_seed(1),
                                    2, 32, device="cpu")
    calls = []
    plain = attention.f32_product

    def counted(a, b):
        calls.append(torch.is_grad_enabled())
        return plain(a, b)
    monkeypatch.setattr(attention, "f32_product", counted)
    loss, _, grads = value_and_grad(
        cfg, opts=ModelOpts(attn_compute_dtype="bf16_accum32"))(params,
                                                                batch)
    assert len(calls) == 6 * cfg.num_layers, calls
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in leaves(grads))
    wq = grads["layers"][0]["attn"]["wq"]
    assert wq.abs().max() > 0
    monkeypatch.setattr(attention, "f32_product", plain)
    loss32, _, _ = value_and_grad(cfg)(params, batch)
    assert abs(float(loss) - float(loss32)) < 1e-2


def test_f32_product_routes():
    """CPU: the product of f32 copies; ``meta``: ``bmm``'s ``out_dtype``
    form for two bf16 operands (and the plain one for f32), with a
    backward in the operands' dtypes."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models.attention import _ScoresF32, f32_product
    gen = torch.Generator().manual_seed(SEED)
    a = torch.randn((3, 5, 16), generator=gen).bfloat16()
    b = torch.randn((3, 16, 7), generator=gen).bfloat16()
    got = f32_product(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bmm(a.float(), b.float()))

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func)
            return func(*args, **(kwargs or {}))
    am, bm = (t.to("meta").requires_grad_() for t in (a, b))
    with Ops() as ops:
        out = _ScoresF32.apply(am, bm)
    assert out.dtype == torch.float32 and out.shape == (3, 5, 7)
    assert torch.ops.aten.bmm.dtype in ops.seen
    out.sum().backward()
    assert am.grad.dtype == bm.grad.dtype == torch.bfloat16
    with Ops() as ops:
        f32_product(am.detach().float(), bm.detach().float())
    assert torch.ops.aten.bmm.default in ops.seen


def test_counters_count_bmm_dtype():
    """``bmm.dtype``'s FLOPs (the stock formula raises on it): forward and
    the backward's two products, 2 N M K P each."""
    from repro_torch.analysis.counters import count
    from repro_torch.models.attention import _ScoresF32
    n, m, k, p = 3, 5, 16, 7
    a = torch.empty((n, m, k), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    b = torch.empty((n, k, p), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    with count([a, b]) as c:
        _ScoresF32.apply(a, b).sum().backward()
    assert c.aten_flops == 3 * 2 * n * m * k * p


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present, decided when the
    test runs (never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("bmm's out_dtype form runs only on a GPU")


def test_sdpa_bf16_accum32_on_card_matches_cpu_route(card):
    """The card's route (``bmm.dtype`` forward and backward) against the
    CPU's (f32 copies) on the causal case's bf16 inputs: both sum exact
    products in f32, in other orders, so a probability or an output may
    round to the other bf16 neighbour.  The output row by row within 1e-2
    of its norm; each gradient within GRAD_TOL of its largest entry, as
    against the reference (a row is no yardstick there: the first
    query's gradient is ~0, its softmax over one key having none)."""
    from repro_torch.models.attention import _mask_bias, _sdpa
    case = CASES["causal"]
    *qkv, pos = _inputs(case)

    def run(dev):
        x = [torch.from_numpy(a).to(dev).bfloat16().requires_grad_()
             for a in qkv]
        p = torch.from_numpy(pos).to(dev)
        out = _sdpa(*x, _mask_bias(p, p, None, True), case[4] ** -0.5,
                    "bf16_accum32")
        w = torch.from_numpy(_cotangent(case)).to(dev)
        (out.float() * w).sum().backward()
        return [t.float().cpu() for t in [out] + [a.grad for a in x]]
    (out, *grads), (want, *want_grads) = run("cuda"), run("cpu")
    assert torch.isfinite(out).all()
    err = (out - want).norm(dim=-1) / want.norm(dim=-1).clamp(min=1e-30)
    assert err.max() <= 1e-2, err.max()
    for got, w in zip(grads, want_grads):
        assert torch.isfinite(got).all()
        scale = w.abs().max()
        assert scale > 0
        assert (got - w).abs().max() <= GRAD_TOL * scale
