"""The plain versions of the envelope probe's kernels P1-P3 against the
kernel bodies of ``tools/mxu_probe.py`` in Pallas interpret mode, the tf32
rounding helper against hand-computed bit patterns, and the probe's entry
point and wrappers on the CPU.

The Pallas bodies are rebuilt here as ``tools/mxu_probe.py:87-98, 112-132,
150-162`` write them (they are closures inside its ``main``), at small
shapes: copy R = 512 in tiles of 256, matmul M, K, N = 32, 16, 64 with 3
reps, the FMA chain on (64, 128) for 16 steps; inputs drawn as the probe
draws them.  Tolerances: rtol 1e-5 / atol 1e-6 (fp32 summation order; the
FMA chain's one rounding a step against two); P1 exact; the tf32 mode,
whose operands are rounded to tf32, against the JAX "f32 DEFAULT" product,
which is fp32 on the CPU, within 2e-3 of the result's largest magnitude.
The CUDA kernels themselves are held to these plain versions on the card
by chip_smoke.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from jax.lax import Precision

from csmpn_torch.ops import probe_kernels as pk
from csmpn_torch.tools import envelope_probe as ep

RTOL, ATOL = 1e-5, 1e-6
R, T = 512, 256
M, K, N, REPS = 32, 16, 64, 3
FMA_SHAPE, FMA_STEPS = (64, 128), 16


def small_inputs():
    return ep.inputs(R, (M, K, N), FMA_SHAPE)


def jax_copy(x):
    def kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0

    return pl.pallas_call(
        kernel,
        grid=(R // T,),
        in_specs=[pl.BlockSpec((T, 256), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((T, 256), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R, 256), jnp.float32),
        interpret=True,
    )(x)


def jax_resident(xs, w, in_dt, prec, reps):
    def kernel(x_ref, w_ref, o_ref):
        a = x_ref[:].astype(in_dt)
        b = w_ref[:].astype(in_dt)
        acc = jnp.zeros((M, N), jnp.float32)
        for _ in range(reps):
            acc = acc + jnp.dot(a, b, preferred_element_type=jnp.float32,
                                precision=prec)
            a = a + a * jnp.asarray(1e-7, in_dt)
        o_ref[:] = acc

    return pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        compiler_params=pltpu.CompilerParams(vmem_limit_bytes=100 << 20),
        interpret=True,
    )(xs, w)


def jax_vpu(big, reps):
    def kernel(x_ref, o_ref):
        v = x_ref[:]
        for _ in range(reps):
            v = v * 1.0001 + 0.001
        o_ref[:] = v

    return pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(big.shape, jnp.float32),
        interpret=True,
    )(big)


def test_plain_copy_matches_pallas_interpret():
    x = small_inputs()[0]
    want = np.asarray(jax_copy(jnp.asarray(x.numpy())))
    got = pk.copy_scale_plain(x).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,in_dt,prec,rtol,atol", [
    ("bf16", jnp.bfloat16, Precision.DEFAULT, RTOL, ATOL),
    ("fp32", jnp.float32, Precision.HIGHEST, RTOL, ATOL),
    ("tf32", jnp.float32, Precision.DEFAULT, None, None),
])
def test_plain_resident_matches_pallas_interpret(mode, in_dt, prec, rtol,
                                                 atol):
    _, a, b, _ = small_inputs()
    want = np.asarray(jax_resident(jnp.asarray(a.numpy()),
                                   jnp.asarray(b.numpy()), in_dt, prec, REPS))
    got = pk.resident_matmul_plain(a, b, REPS, mode).numpy()
    assert got.shape == (M, N) and got.dtype == np.float32
    if mode == "tf32":
        # operands rounded to tf32 against fp32 operands
        err = np.abs(got - want).max()
        assert err <= 2e-3 * np.abs(want).max(), err
        assert err > 0      # the rounding does take place
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_plain_fma_chain_matches_pallas_interpret():
    v = small_inputs()[3]
    want = np.asarray(jax_vpu(jnp.asarray(v.numpy()), FMA_STEPS))
    got = pk.fma_chain_plain(v, FMA_STEPS).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_resident_perturbs_in_operand_type():
    """bf16: a * 1e-7 is below half an ulp, so every rep adds the same
    product; fp32: a grows by a factor (1 + 1e-7) a rep, rounded."""
    _, a, b, _ = small_inputs()
    one = pk.resident_matmul_plain(a, b, 1, "bf16")
    np.testing.assert_array_equal(
        pk.resident_matmul_plain(a, b, REPS, "bf16").numpy(),
        (one + one + one).numpy())
    f1 = pk.resident_matmul_plain(a, b, 1, "fp32")
    f3 = pk.resident_matmul_plain(a, b, REPS, "fp32")
    assert not torch.equal(f3, f1 + f1 + f1)
    np.testing.assert_allclose(f3.numpy(), 3 * f1.numpy(), rtol=1e-5,
                               atol=1e-5)


def bits(*words):
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("case,inp,want", [
    # 1.0 and values already on the tf32 grid stay
    ("exact", [0x3F800000, 0x3F802000, 0x00000000, 0x80000000],
     [0x3F800000, 0x3F802000, 0x00000000, 0x80000000]),
    # below half an ulp (0x1000) rounds down, above rounds up
    ("nearest", [0x3F800FFF, 0x3F801001, 0x40490FDB],
     [0x3F800000, 0x3F802000, 0x40490000]),
    # exact ties go away from zero, for either sign
    ("ties", [0x3F801000, 0x3F803000, 0xBF801000, 0xBF803000],
     [0x3F802000, 0x3F804000, 0xBF802000, 0xBF804000]),
    # negatives round by magnitude
    ("negative", [0xBF800FFF, 0xBF801001, 0xC0490FDB],
     [0xBF800000, 0xBF802000, 0xC0490000]),
    # the carry runs into the exponent
    ("carry", [0x3FFFF000, 0x3FFFFFFF, 0xBFFFF000, 0x3FFFEFFF],
     [0x40000000, 0x40000000, 0xC0000000, 0x3FFFE000]),
    # infinities and NaNs pass through
    ("special", [0x7F800000, 0xFF800000, 0x7FC00001, 0x7F800FFF],
     [0x7F800000, 0xFF800000, 0x7FC00001, 0x7F800FFF]),
])
def test_round_tf32_bit_patterns(case, inp, want):
    got = pk.round_tf32(bits(*inp).view(torch.float32)).view(torch.int32)
    assert got.tolist() == bits(*want).tolist(), case


def test_round_tf32_matches_ten_bit_rounding():
    """Against an independent rounding in float64: the nearest value with
    a 10-bit mantissa, ties away from zero."""
    rng = np.random.RandomState(1)
    x = (rng.randn(4096) * 10.0 ** rng.randint(-20, 20, size=4096)
         ).astype(np.float32)
    m, e = np.frexp(x.astype(np.float64))          # x = m 2^e, |m| in [0.5, 1)
    q = np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5) / 2 ** 11
    want = np.ldexp(q, e).astype(np.float32)
    got = pk.round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_inputs_follow_the_probes_draw_order():
    x, a, b, v = small_inputs()
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(x.numpy(), rng.randn(R, 256)
                                  .astype(np.float32))
    np.testing.assert_array_equal(a.numpy(), rng.randn(M, K)
                                  .astype(np.float32))
    np.testing.assert_array_equal(b.numpy(), rng.randn(K, N)
                                  .astype(np.float32) / 16)
    np.testing.assert_array_equal(v.numpy(), rng.randn(*FMA_SHAPE)
                                  .astype(np.float32))


def test_work_and_bounds_at_the_default_sizes():
    w = ep.work()
    assert w["copy"]["bytes"] == 268_435_456
    assert w["resident"]["flops"] == 17_179_869_184
    assert w["fma"]["flops"] == 1_073_741_824
    ms, by = ep.bound_ms(w["copy"]["bytes"], w["copy"]["flops"],
                         ep.DATA_SHEET["fp32"])
    assert by == "bytes" and abs(ms - 0.0801) < 1e-4
    ms_bf16, by = ep.bound_ms(w["resident"]["bytes"], w["resident"]["flops"],
                              ep.DATA_SHEET["bf16"])
    assert by == "operations" and abs(ms_bf16 - 0.01737) < 1e-5
    ms, _ = ep.bound_ms(w["resident"]["bytes"], w["resident"]["flops"],
                        ep.DATA_SHEET["tf32"])
    assert abs(ms - 0.03471) < 1e-5
    ms, by = ep.bound_ms(w["fma"]["bytes"], w["fma"]["flops"],
                         ep.DATA_SHEET["fma"])
    assert by == "operations" and abs(ms - 0.01603) < 1e-5
    # P2's perturbations (2 M K a rep after the first) at the fp32 rate
    ms_e, _ = ep.bound_ms(w["resident"]["bytes"], w["resident"]["flops"],
                          ep.DATA_SHEET["bf16"],
                          elementwise=w["resident"]["elementwise"])
    assert abs(ms_e - ms_bf16 - 2 * 512 * 256 * 31 / 67e12 * 1e3) < 1e-9


@pytest.mark.parametrize("mode", pk.MODES)
def test_wrappers_take_the_plain_version_on_cpu(mode):
    x, a, b, v = small_inputs()
    before = (pk.COPY_LAUNCHES.count, pk.RESIDENT_LAUNCHES[mode].count,
              pk.FMA_LAUNCHES.count)
    assert torch.equal(pk.copy_scale(x, 64), pk.copy_scale_plain(x))
    assert torch.equal(pk.resident_matmul(a, b, REPS, mode),
                       pk.resident_matmul_plain(a, b, REPS, mode))
    assert torch.equal(pk.fma_chain(v, FMA_STEPS),
                       pk.fma_chain_plain(v, FMA_STEPS))
    assert (pk.COPY_LAUNCHES.count, pk.RESIDENT_LAUNCHES[mode].count,
            pk.FMA_LAUNCHES.count) == before
    with pytest.raises(ValueError):
        pk.resident_matmul(a, b, REPS, "fp16")


def test_envelope_probe_main_on_cpu(capsys):
    res = ep.main(["--device=cpu", f"--rows={R}", "--steps=1",
                   "--repeats=1", f"--reps={REPS}", f"--mkn={M},{K},{N}",
                   "--fma-shape=64,128"])
    text = capsys.readouterr().out.splitlines()
    assert text[0].startswith("# cpu:")
    assert sum(l.startswith("copy plain (cpu) tile") for l in text) == 4
    assert sum(l.startswith("resident matmul") for l in text) == 3
    assert any(l.startswith("fma chain") for l in text)
    assert text[-1].startswith("host rates of the plain versions")
    assert res["device"] == "cpu" and res["card"] is None
    assert set(res["envelope"]) == {"copy", "bf16", "tf32", "fp32", "fma"}
    assert all(np.isfinite(r) and r > 0 for r in res["envelope"].values())
    assert set(res["copy"]["library_ms"]) == {"x*2", "copy_"}
    assert set(res["resident"]["library_ms"]) == set(pk.MODES)


def test_envelope_probe_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        ep.main([])
    with pytest.raises(RuntimeError, match="CUDA card"):
        ep.measure()


def test_import_builds_nothing():
    """With no nvcc to be found a build would raise: importing the probe
    and its kernels' module must not try."""
    code = ("import csmpn_torch.tools.envelope_probe\n"
            "from csmpn_torch.ops import _build\n"
            "assert 'envelope' in _build.SOURCES and not _build._libs\n")
    env = dict(os.environ, CUDA_HOME="/nonexistent", PATH="/usr/bin:/bin")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(os.path.dirname(__file__)))
