"""The port's gradient of the GANAX ops against the JAX package's.

* ``dx``, ``dw`` and ``db`` of ``repro_torch.core.dataflow.tconv/conv``
  on the kernel backend (on the CPU: the kernel's plain version, through
  the port's ``torch.autograd.Function``) against ``jax.vjp`` of the
  reference's custom VJP under ``backend="pallas-interpret"``, on the
  same numpy inputs and cotangents, for the geometries training runs:
  the g-layers' stride-2 tconvs, D's stride-2 convs with Cin = 3 or 1
  (d1), the 4×4 stride-1 pad-0 logits conv with Cout = 1 (d5), a
  stride-1 pad-0 tconv from a 1×1 input with Cin = 1 (d5's adjoint),
  odd sizes with a stride tail, 2-D and 3-D;
* a second oracle: PyTorch's native autograd through the port's
  ``polyphase`` backend, for every activation with and without bias;
* the activation derivative from the output, first-order-only
  behaviour, and that the backward computes only what is asked for.

Tolerance: atol = rtol = 1e-4 (f32 on both sides, summed in another
order over at most a few hundred terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro_torch.core import dataflow as tdf
from repro_torch.kernels import ops

TOL = dict(atol=1e-4, rtol=1e-4)
ACTS = ["none", "relu", "leaky_relu", "tanh"]

# (x shape, w shape, strides, paddings, transposed, activation, bias);
# the smallest shapes, since the Pallas kernels interpret at Python speed
REF_CASES = [
    # g-layer: 4×4 stride-2 pad-1 tconv, Cout = 3 (its adjoint reads Cin 3)
    ((2, 4, 4, 4), (4, 4, 4, 3), (2, 2), (1, 1), True, "tanh", True),
    # d1: Cin = 3, stride 2, pad 1, odd input (a stride tail in dx)
    ((2, 9, 9, 3), (4, 4, 3, 4), (2, 2), (1, 1), False, "leaky_relu", True),
    # d5: 4×4 stride 1 pad 0, 4×4 → 1×1, Cout = 1, no activation
    ((2, 4, 4, 6), (4, 4, 6, 1), (1, 1), (0, 0), False, "none", True),
    # d5's adjoint as a forward op: 1×1 input, Cin = 1, stride 1, pad 0
    ((2, 1, 1, 1), (4, 4, 1, 5), (1, 1), (0, 0), True, "relu", False),
    # stride 1, pad 1, odd sizes, no bias
    ((1, 5, 7, 3), (3, 3, 3, 4), (1, 1), (1, 1), False, "relu", False),
    ((1, 5, 3, 2), (3, 3, 2, 3), (1, 1), (1, 1), True, "none", False),
    # 3-D: 3D-GAN g4 (Cout = 1), d1 (Cin = 1, odd size), d5, a s1 tconv
    ((1, 3, 3, 3, 4), (4, 4, 4, 4, 1), (2, 2, 2), (1, 1, 1), True, "tanh",
     True),
    ((1, 7, 6, 6, 1), (4, 4, 4, 1, 2), (2, 2, 2), (1, 1, 1), False,
     "leaky_relu", True),
    ((2, 4, 4, 4, 3), (4, 4, 4, 3, 1), (1, 1, 1), (0, 0, 0), False, "none",
     True),
    ((1, 2, 3, 2, 2), (3, 3, 3, 2, 3), (1, 1, 1), (0, 0, 0), True, "relu",
     False),
]


def _case_id(case):
    xs, ws, s, p, tr, act, bias = case
    return (f"{'tconv' if tr else 'conv'}{len(s)}d-x{'x'.join(map(str, xs))}"
            f"-k{ws[0]}s{s[0]}p{p[0]}-cout{ws[-1]}-{act}"
            f"{'-bias' if bias else ''}")


def _inputs(xs, ws, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=xs).astype(np.float32)
    w = (0.5 * rng.normal(size=ws)).astype(np.float32)
    b = (0.3 * rng.normal(size=ws[-1])).astype(np.float32)
    return rng, x, w, b


def _torch_vjp(op, x, w, b, g, s, p, ep, backend=None):
    """(y, dx, dw, db) of the port on the CPU; ``db`` None without bias."""
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True) if ep.bias else None
    y = op(xt, wt, s, p, backend=backend, bias=bt, epilogue=ep)
    leaves = (xt, wt) + ((bt,) if ep.bias else ())
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    return (y.detach(),) + grads + ((None,) if not ep.bias else ())


@pytest.mark.parametrize("case", REF_CASES, ids=_case_id)
def test_vjp_matches_reference_custom_vjp(case):
    xs, ws, s, p, transposed, act, has_bias = case
    rng, x, w, b = _inputs(xs, ws, seed=len(xs) + ws[-1])
    jep = jdf.Epilogue(bias=has_bias, activation=act)
    tep = tdf.Epilogue(bias=has_bias, activation=act)
    policy = jdf.DataflowPolicy(backend="pallas-interpret")
    jop = jdf.tconv if transposed else jdf.conv

    def f(x, w, b):
        return jop(x, w, s, p, policy=policy, bias=b if has_bias else None,
                   epilogue=jep)

    y_ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    dx_ref, dw_ref, db_ref = vjp(jnp.asarray(g))
    y, dx, dw, db = _torch_vjp(tdf.tconv if transposed else tdf.conv,
                               x, w, b, g, s, p, tep)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    assert np.abs(np.asarray(dx_ref)).max() > 1e-3   # not vacuous
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), **TOL,
                               err_msg="dx")
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), **TOL,
                               err_msg="dw")
    if has_bias:
        np.testing.assert_allclose(db.numpy(), np.asarray(db_ref), **TOL,
                                   err_msg="db")


# (x shape, w shape, strides, paddings): 2-D and 3-D, stride 2 and 1,
# padding 1 and 0, Cin = 3 and 1, odd sizes
GEOMETRIES = {
    "tconv": [((2, 4, 5, 3), (4, 4, 3, 5), (2, 2), (1, 1)),
              ((2, 1, 1, 1), (4, 4, 1, 4), (1, 1), (0, 0)),
              ((1, 3, 2, 3, 2), (4, 4, 4, 2, 1), (2, 2, 2), (1, 1, 1))],
    "conv": [((2, 9, 8, 3), (4, 4, 3, 5), (2, 2), (1, 1)),
             ((2, 4, 4, 6), (4, 4, 6, 1), (1, 1), (0, 0)),
             ((1, 7, 6, 5, 1), (4, 4, 4, 1, 3), (2, 2, 2), (1, 1, 1))],
}


@pytest.mark.parametrize("has_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("kind", ["tconv", "conv"])
def test_vjp_matches_native_autograd_of_polyphase(kind, act, has_bias):
    op = tdf.tconv if kind == "tconv" else tdf.conv
    ep = tdf.Epilogue(bias=has_bias, activation=act)
    for i, (xs, ws, s, p) in enumerate(GEOMETRIES[kind]):
        rng, x, w, b = _inputs(xs, ws, seed=100 + i)
        with torch.no_grad():
            y = op(torch.from_numpy(x), torch.from_numpy(w), s, p,
                   bias=torch.from_numpy(b) if has_bias else None,
                   epilogue=ep)
        g = rng.normal(size=tuple(y.shape)).astype(np.float32)
        got = _torch_vjp(op, x, w, b, g, s, p, ep)
        ref = _torch_vjp(op, x, w, b, g, s, p, ep, backend="polyphase")
        for name, a, r in zip(("y", "dx", "dw", "db"), got, ref):
            if r is not None:
                torch.testing.assert_close(a, r, **TOL,
                                           msg=f"{name} {xs} {ws}")


@pytest.mark.parametrize("act", ACTS)
def test_grad_from_output_matches_reference(act):
    y = np.array([[-1.5, -0.25, 0.0, 0.0, 1e-7, 0.5, 0.999]], np.float32)
    ref = jdf.Epilogue(activation=act, leaky_slope=0.3).grad_from_output(
        jnp.asarray(y))
    got = tdf.Epilogue(activation=act, leaky_slope=0.3).grad_from_output(
        torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["tconv", "conv"])
def test_second_order_raises_clearly(kind):
    """The kernel backends define one backward pass: grad-of-grad raises
    the port's SecondOrderNotImplemented with the reference's guidance,
    while the first order works; a polyphase/zero-insert graph keeps
    native higher-order autograd."""
    op = tdf.tconv if kind == "tconv" else tdf.conv
    x = torch.ones((1, 4, 4, 2), requires_grad=True)
    w = torch.ones((3, 3, 2, 2), requires_grad=True)

    def loss(backend):
        return torch.sum(op(x, w, (2, 2), (1, 1), backend=backend) ** 2)

    (gx,) = torch.autograd.grad(loss(None), x)         # first order
    (gx2,) = torch.autograd.grad(loss(None), x, create_graph=True)
    torch.testing.assert_close(gx2.detach(), gx, rtol=0, atol=0)
    with pytest.raises(tdf.SecondOrderNotImplemented,
                       match="pure-PyTorch backend"):
        torch.autograd.grad(gx2.sum(), x)
    hess = {}
    for backend in ("polyphase", "zero-insert"):
        (g,) = torch.autograd.grad(loss(backend), x, create_graph=True)
        (hess[backend],) = torch.autograd.grad(g.sum(), x)
    torch.testing.assert_close(hess["polyphase"], hess["zero-insert"],
                               **TOL)


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)
    return calls


def test_backward_computes_only_what_is_asked_for(monkeypatch):
    """``needs_input_grad`` decides: no ``dx`` launch for an input that
    needs no gradient, no ``dw`` contraction for frozen weights; and the
    serving path records no graph at all."""
    tconv_calls = _count_calls(monkeypatch, ops, "ganax_conv_transpose")
    wgrad_calls = _count_calls(monkeypatch, tdf, "_conv_wgrad")
    x = torch.randn((2, 8, 8, 3))
    w = torch.randn((4, 4, 3, 4), requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    ep = tdf.Epilogue(bias=True, activation="leaky_relu")
    y = tdf.conv(x, w, (2, 2), (1, 1), bias=b, epilogue=ep)
    dw, db = torch.autograd.grad(y.sum(), (w, b))
    assert (tconv_calls, wgrad_calls) == ([], ["_conv_wgrad"])
    assert dw.shape == w.shape and db.shape == b.shape
    xg = x.clone().requires_grad_()
    y = tdf.conv(xg, w.detach(), (2, 2), (1, 1), bias=b.detach(),
                 epilogue=ep)
    (dx,) = torch.autograd.grad(y.sum(), xg)
    assert dx.shape == x.shape
    assert (tconv_calls, wgrad_calls) == (["ganax_conv_transpose"],
                                          ["_conv_wgrad"])
    with torch.inference_mode():
        y = tdf.conv(xg, w, (2, 2), (1, 1), bias=b, epilogue=ep)
    assert y.grad_fn is None and not y.requires_grad
    assert type(tdf.conv(xg, w, (2, 2), (1, 1)).grad_fn).__name__ == \
        "_KernelOpBackward"


def test_ganax_plain_backend_differentiates_through_the_plain_version():
    rng, x, w, b = _inputs((2, 4, 4, 3), (4, 4, 3, 2), seed=3)
    ep = tdf.Epilogue(bias=True, activation="relu")
    g = rng.normal(size=(2, 8, 8, 2)).astype(np.float32)
    got = _torch_vjp(tdf.tconv, x, w, b, g, (2, 2), (1, 1), ep,
                     backend="ganax-plain")
    ref = _torch_vjp(tdf.tconv, x, w, b, g, (2, 2), (1, 1), ep)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
