"""``raytrace_tpu_torch.mathfn``: the port's square root, sine and cosine.

On a CPU tensor ``sqrt`` is correctly rounded, bit for bit numpy's
``np.sqrt`` (and XLA's), in float64 and float32; float32 ``sin`` and ``cos``
are the float64 ones rounded once. Plain ``torch.sqrt`` does not pass the
first test on every host: on an AVX-512 x86 host with torch 2.13.0+cpu it
is one ulp off numpy on 2,719 of the 200,000 uniform float64 inputs of
``sqrt_inputs`` and 2,645 of its 200,000 random bit patterns, and on
38,986 and 33,919 of the float32 ones (about 2,779 and 38,184 of any
200,000 uniform float64 and float32 draws on that host). On a CUDA tensor
each function is torch's op, bit for bit. Derivatives are the ops' own in
reverse and forward mode. No tensor square root or trig call of the port
bypasses the module.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raytrace_tpu_torch import mathfn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 200_000
DTYPES = {"float64": (np.float64, np.int64, torch.float64),
          "float32": (np.float32, np.int32, torch.float32)}


def sqrt_inputs(name, seed=0):
    """N uniform on [0, 1000) and N positive finite numbers of uniformly
    random bit patterns (every exponent, subnormals included)."""
    np_dtype, int_dtype, _ = DTYPES[name]
    rng = np.random.default_rng(seed)
    uniform = rng.uniform(0.0, 1000.0, N).astype(np_dtype)
    top = np.array(np.inf, dtype=np_dtype).view(int_dtype)
    bits = rng.integers(1, top, N, dtype=int_dtype).view(np_dtype)
    return np.concatenate([uniform, bits])


def trig_inputs(seed=1):
    """N float32 angles: uniform on [-4 pi, 4 pi] and a log-uniform tail
    from 1e-6 to 1e4 of both signs."""
    rng = np.random.default_rng(seed)
    wide = rng.uniform(-4 * np.pi, 4 * np.pi, N // 2)
    tail = 10.0 ** rng.uniform(-6, 4, N - N // 2) * rng.choice([-1.0, 1.0], N - N // 2)
    return np.concatenate([wide, tail]).astype(np.float32)


@pytest.mark.parametrize("name", DTYPES)
def test_sqrt_is_numpy_bit_for_bit(name):
    x = sqrt_inputs(name)
    got = mathfn.sqrt(torch.from_numpy(x)).numpy()
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got.view(DTYPES[name][1]), np.sqrt(x).view(DTYPES[name][1]))


@pytest.mark.parametrize("name", DTYPES)
def test_sqrt_special_values_are_torchs(name):
    np_dtype, int_dtype, dtype = DTYPES[name]
    finfo = np.finfo(np_dtype)
    x = np.array([0.0, -0.0, finfo.smallest_subnormal, 3 * finfo.smallest_subnormal,
                  finfo.smallest_normal * 0.75, finfo.smallest_normal, finfo.max, np.inf,
                  -np.inf, np.nan, -1.0, -finfo.smallest_subnormal, 1.0, 4.0, 2.0],
                 dtype=np_dtype)
    t = torch.from_numpy(x)
    got = mathfn.sqrt(t)
    plain = torch.sqrt(t)
    assert got.dtype == dtype and got.shape == t.shape
    nan = np.isnan(plain.numpy())
    np.testing.assert_array_equal(np.isnan(got.numpy()), nan)
    np.testing.assert_array_equal(got.numpy()[~nan].view(int_dtype),
                                  np.sqrt(x)[~nan].view(int_dtype))
    assert torch.signbit(got[1]) and got[1] == 0  # sqrt(-0.) = -0.
    assert got[2] > 0 and got[7] == np.inf and (got[[8, 9, 10, 11]].isnan()).all()


def test_sqrt_keeps_shape_strides_and_scalars():
    x = torch.rand(5, 7, dtype=torch.float64).t()
    got = mathfn.sqrt(x)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x.numpy()))
    assert mathfn.sqrt(torch.tensor(2.25, dtype=torch.float64)).item() == 1.5
    assert torch.equal(mathfn.sqrt(torch.tensor([4, 9])), torch.sqrt(torch.tensor([4, 9])))


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_float32_trig_is_float64_rounded_once(fn):
    x = torch.from_numpy(trig_inputs())
    got = getattr(mathfn, fn)(x)
    want = getattr(torch, fn)(x.double()).float()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
    assert torch.signbit(getattr(mathfn, fn)(torch.tensor(-0.0))) == (fn == "sin")


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_float64_trig_is_torchs(fn):
    x = torch.from_numpy(trig_inputs().astype(np.float64))
    assert torch.equal(getattr(mathfn, fn)(x), getattr(torch, fn)(x))


def test_sqrt_gradients_float64():
    """gradcheck in reverse and forward mode (batched too), forward mode
    against reverse mode, and the derivative equal to torch's own rule
    1 / (2 sqrt(x)) on the helper's value."""
    x = torch.linspace(0.3, 40.0, 9, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(mathfn.sqrt, (x,), check_forward_ad=True,
                                    check_batched_grad=True, check_batched_forward_grad=True)
    f = lambda v: mathfn.sqrt(v * v + 1.0) * mathfn.sqrt(v)  # noqa: E731
    rev = torch.func.jacrev(f)(x.detach())
    fwd = torch.func.jacfwd(f)(x.detach())
    torch.testing.assert_close(fwd, rev, rtol=1e-15, atol=0.0)
    from torch.autograd import forward_ad as fwad

    with fwad.dual_level():
        dual = fwad.make_dual(x.detach(), torch.ones_like(x))
        out = fwad.unpack_dual(f(dual))
    torch.testing.assert_close(out.tangent, torch.diagonal(rev), rtol=1e-15, atol=0.0)
    torch.testing.assert_close(out.primal, f(x.detach()), rtol=0.0, atol=0.0)
    (g,) = torch.autograd.grad(mathfn.sqrt(x).sum(), x)
    assert torch.equal(g, 1.0 / (2 * mathfn.sqrt(x.detach())))


@pytest.mark.parametrize("fn, d", [("sin", "cos"), ("cos", "sin")])
def test_float32_trig_derivatives_are_torchs(fn, d):
    """The derivative of float32 sin (cos) is torch's float32 cos (-sin), in
    reverse mode, forward mode and under torch.func; the value is the
    helper's with or without a derivative attached."""
    x = torch.from_numpy(trig_inputs()[:512]).requires_grad_()
    out = getattr(mathfn, fn)(x)
    assert torch.equal(out.detach(), getattr(mathfn, fn)(x.detach()))
    (g,) = torch.autograd.grad(out.sum(), x)
    want = getattr(torch, d)(x.detach()) * (1.0 if fn == "sin" else -1.0)
    assert torch.equal(g, want)
    jac = torch.func.jacfwd(getattr(mathfn, fn))(x.detach()[:16])
    assert torch.equal(torch.diagonal(jac), want[:16])


@pytest.mark.cuda
def test_on_the_card_each_function_is_torchs_op():
    """On a CUDA tensor the helper is torch's op, bit for bit: the march
    kernel and its plain version keep the bits they share."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for name in DTYPES:
        x = torch.from_numpy(sqrt_inputs(name)).cuda()
        assert torch.equal(mathfn.sqrt(x), torch.sqrt(x))
        a = torch.from_numpy(trig_inputs()).to("cuda", DTYPES[name][2])
        assert torch.equal(mathfn.sin(a), torch.sin(a))
        assert torch.equal(mathfn.cos(a), torch.cos(a))


def _bypasses(tree):
    """The calls that take a tensor square root, sine or cosine around
    mathfn: ``torch.sqrt/sin/cos(...)``, and a ``.sqrt()``, ``.sin()`` or
    ``.cos()`` method call with no argument."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        attr, owner = node.func.attr, node.func.value
        if attr not in ("sqrt", "sin", "cos"):
            continue
        if isinstance(owner, ast.Name) and owner.id == "torch":
            yield f"torch.{attr}(...) at line {node.lineno}"
        elif not node.args and not node.keywords:
            yield f".{attr}() at line {node.lineno}"


def test_no_port_module_bypasses_mathfn():
    files = sorted((ROOT / "raytrace_tpu_torch").rglob("*.py"))
    assert len(files) > 40
    bad = {}
    for path in files:
        if path.name == "mathfn.py" and path.parent.name == "raytrace_tpu_torch":
            continue
        found = list(_bypasses(ast.parse(path.read_text(), filename=str(path))))
        if found:
            bad[str(path.relative_to(ROOT))] = found
    assert not bad, bad


def test_the_walk_sees_what_it_forbids():
    src = ("import math, numpy as np, torch\nfrom raytrace_tpu_torch import mathfn\n"
           "a = torch.sqrt(x)\nb = x.sqrt()\nc = torch.sin(x) + torch.cos(y)\n"
           "d = math.sqrt(2.0) + np.sqrt(3.0) + mathfn.sqrt(x) + mathfn.sin(x)\n"
           "e = (x * x).cos()\n")
    assert sorted(_bypasses(ast.parse(src))) == [
        ".cos() at line 7", ".sqrt() at line 4", "torch.cos(...) at line 5",
        "torch.sin(...) at line 5", "torch.sqrt(...) at line 3"]
