"""Where the RG-LRU forward kernel's long-memory error comes from.

On the card, ``chip_smoke.py`` holds ``csrc/rglru_scan.cu`` to its plain
version (``rglru_scan_ref``) on the Griffin paper's long memory (a^8 in
[0.9, 0.999]): the error reached 0.232 of the limit (1e-4 absolute plus
1e-4 relative). Here the kernel's float32 arithmetic is emulated on the CPU
and one source changed at a time, each against the plain version's
arithmetic and against a float64 oracle:

* ``square``: 1 - a² as nvcc compiles ``1.f - a * a`` (one fused
  multiply-add) or from a rounded square, as the plain version forms it;
* ``update``: h = a h + x as one fused multiply-add or two roundings;
* ``exp``: float32 exp, or exp rounded once from float64 (the two differ
  by an ulp; on the card the kernel and the plain version call the same
  ``expf``);
* ``chunk``: the kernel's chunked association of the carry (chunks of
  128, folded in chunk order) or the sequential scan.

The fused 1 - a² explains about nine tenths of the error; the rest is the
chunked association, inherent to the kernel's parallel design. The kernel
now forms the square rounded (``__fmul_rn``). Run as a script for the
table at ``chip_smoke.py``'s shape (2 x 4096 x 2560).
"""
import math
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru_scan import rglru_scan_ref
from repro_torch.kernels.rglru_scan.ops import CHUNK

torch.set_num_threads(2)

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
          / "rglru_scan" / "csrc" / "rglru_scan.cu")


def _fma(a, b, c):
    """fmaf in float32 (the product exact in float64, one rounding)."""
    return (a.double() * b.double() + c.double()).float()


def emulate(x_in, log_a, *, square="rounded", update="fma", exp="f32", chunk=CHUNK):
    """The scan h_t = a_t h_{t-1} + sqrt(max(1 - a_t², 1e-12)) x_in_t in
    float32, rounded as the options say (see the module's docstring);
    ``chunk=None`` is the sequential scan."""
    a = torch.exp(log_a) if exp == "f32" else torch.exp(log_a.double()).float()
    om = 1.0 - a * a if square == "rounded" else _fma(-a, a, torch.ones_like(a))
    xg = torch.sqrt(torch.clamp(om, min=1e-12)) * x_in
    step = _fma if update == "fma" else (lambda a_, h, x: a_ * h + x)
    S = x_in.shape[1]
    out = torch.empty_like(x_in)
    starts = list(range(0, S, chunk or S))
    carries = [torch.zeros_like(x_in[:, 0])]
    for t0 in starts[:-1]:                 # each chunk but the last from 0
        prod, e = torch.ones_like(carries[0]), torch.zeros_like(carries[0])
        for t in range(t0, t0 + chunk):
            e = step(a[:, t], e, xg[:, t])
            prod = prod * a[:, t]
        carries.append(_fma(prod, carries[-1], e))
    for t0, h in zip(starts, carries):
        for t in range(t0, min(S, t0 + (chunk or S))):
            h = step(a[:, t], h, xg[:, t])
            out[:, t] = h
    return out


def oracle(x_in, log_a):
    """The scan in float64 from the same float32 inputs."""
    a = torch.exp(log_a.double())
    xg = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * x_in.double()
    h, out = torch.zeros_like(a[:, 0]), torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + xg[:, t]
        out[:, t] = h
    return out


def excess(got, want):
    """Largest |got - want| over the card's scan limit, 1e-4 + 1e-4 |want|."""
    want = want.double()
    return ((got.double() - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()


def long_memory(B, S, W, seed=0):
    """x_in normal and log_a as ``chip_smoke.py`` draws long memory:
    -8 softplus(lam) sigmoid(normal), lam spanning a^8 in [0.9, 0.999]."""
    rng = np.random.default_rng(seed)
    lam = torch.log(torch.expm1(torch.linspace(-math.log(0.999) / 8,
                                               -math.log(0.9) / 8, W)))
    z = torch.from_numpy(rng.standard_normal((B, S, W)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B, S, W)).astype(np.float32))
    return x, -8.0 * torch.nn.functional.softplus(lam) * torch.sigmoid(z)


# the kernel as nvcc compiled it before the repair, then one source changed
VARIANTS = {
    "kernel, 1 - a^2 fused (before)": dict(square="fma"),
    "kernel, 1 - a^2 rounded (now)": dict(),
    "  ... and the update in two roundings": dict(update="separate"),
    "  ... and exp rounded from float64": dict(exp="f64"),
    "  ... and the carry sequential": dict(chunk=None),
}


def split(B, S, W, seed=0):
    """{variant: (excess against the plain version's arithmetic, against
    the float64 oracle)}; the plain version is ``rglru_scan_ref``."""
    x, log_a = long_memory(B, S, W, seed)
    plain, exact = rglru_scan_ref(x, log_a), oracle(x, log_a)
    out = {"plain version": (0.0, excess(plain, exact))}
    for name, kw in VARIANTS.items():
        got = emulate(x, log_a, **kw)
        out[name] = (excess(got, plain), excess(got, exact))
    return out


@pytest.fixture(scope="module")
def table():
    return split(2, 4096, 512)


def test_fused_square_is_most_of_the_long_memory_error(table):
    """The fused 1 - a² moves the scan by several times what the rounded
    square leaves (0.19 against 0.027 of the limit at 2 x 4096 x 2560)."""
    fused = table["kernel, 1 - a^2 fused (before)"][0]
    rounded = table["kernel, 1 - a^2 rounded (now)"][0]
    assert fused > 0.1 and rounded < 0.05 and fused > 4 * rounded, table


def test_what_remains_is_the_chunked_association(table):
    """With the rounded square, the fused update is no source (the plain
    version's addcmul makes the same contraction or differs by far less),
    and the sequential carry gives the plain version's bits."""
    x, log_a = long_memory(2, 4096, 512)
    assert table["  ... and the update in two roundings"][0] < 0.05
    assert torch.equal(emulate(x, log_a, chunk=None), rglru_scan_ref(x, log_a))


def test_forward_kernel_forms_the_square_rounded():
    """The repair: ``csrc/rglru_scan.cu`` forms 1 - a² from a rounded
    square, as the plain version and the backward kernel do."""
    text = SOURCE.read_text()
    assert "1.f - __fmul_rn(a, a)" in text and "1.f - a * a" not in text


if __name__ == "__main__":
    for name, (plain, exact) in split(2, 4096, 2560).items():
        print(f"{name:40s} {plain:8.4f} of the limit against the plain version,"
              f" {exact:8.4f} against float64")
