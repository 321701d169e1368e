"""The port's H100 probes (gkr_mimc_tpu_torch.ops.probes) against the JAX
package: the plain version of each probe, on the CPU, on inputs made from
numpy seeds, against the same function in JAX or on Python ints. Exact,
except the f32 body of op_chain (1e-5 relative: the card fuses the multiply
and the add, the CPU's torch does not). The kernels themselves run only on
a card (tests/test_torch_cuda.py, chip_smoke.py phase 9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkr_mimc_tpu.circuits import gates as jgates
from gkr_mimc_tpu.fields import bn254 as jbn
from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu.fields import scalar as jscalar
from gkr_mimc_tpu.sumcheck import prover as jsp
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import NPRIME, P, RINV
from gkr_mimc_tpu_torch.ops import probes as Pr
from gkr_mimc_tpu_torch.utils.convert import to_jax_rows

U32 = jnp.uint32
_R_MASK = (1 << 256) - 1


def _jnp_hi(x, y):
    """hi32(x * y) in uint32 alone: 16-bit halves of both operands."""
    m = U32(0xFFFF)
    xl, xh, yl, yh = x & m, x >> 16, y & m, y >> 16
    mid1, mid2 = xh * yl, xl * yh
    carry = ((mid1 & m) + (mid2 & m) + ((xl * yl) >> 16)) >> 16
    return xh * yh + (mid1 >> 16) + (mid2 >> 16) + carry


def _jnp_step(body, x, y):
    """micro_ops.py's jnp expressions; roll is the warp shuffle's rotation
    of each run of 32 elements, the three multiplies the field core's."""
    if body == "u32 mul":
        return x * y
    if body == "u32 add":
        return x + y
    if body in ("u32 mul+add", "f32 fma"):
        return x * y + y
    if body == "u32 and+shr":
        return (x & y) + (x >> 16)
    if body == "u32 where":
        return jnp.where(x > y, x, y)
    if body == "u32 roll":
        return jnp.roll(x.reshape(-1, 32), 1, axis=1).reshape(x.shape) + y
    if body == "i32<->f32":
        return x.astype(jnp.int32).astype(jnp.float32).astype(jnp.int32).astype(U32) + y
    if body == "u32 mul.hi":
        return _jnp_hi(x, y) + y
    if body == "u32 mul.wide":
        return (x * y) ^ _jnp_hi(x, y)
    if body == "u32 mad.cc":
        t = x * y + y
        return _jnp_hi(x, y) + t + (t < y).astype(U32)
    raise KeyError(body)


def _ints(t):
    return fr.limb_values(t)


def test_op_chain_bodies_match_jnp():
    """Every body at (16, 64), reps = 8, on the script's 16-bit inputs and
    on full 32-bit ones."""
    for body in Pr.OP_BODIES:
        for bits in (16, 32):
            x, y = Pr.op_inputs((16, 64), body, "cpu", bits=bits, seed=bits)
            got = Pr.op_chain(x, y, body, 8)
            if body == "f32 fma":
                jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
            else:
                jx, jy = jnp.asarray(x.numpy().view(np.uint32)), jnp.asarray(y.numpy().view(np.uint32))
            for _ in range(8):
                jx = _jnp_step(body, jx, jy)
            want = np.asarray(jx)
            if body == "f32 fma":
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
            else:
                assert np.array_equal(got.numpy().view(np.uint32), want), (body, bits)


def test_imma_dot_matches_jax_dot_general():
    m, x = Pr.imma_inputs(64, "cpu")
    got = Pr.imma_dot(m, x, 2)
    want = 2 * jax.lax.dot_general(jnp.asarray(m.numpy()), jnp.asarray(x.numpy()), (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


def test_field_check_matches_jax_field():
    """check_mxu_mul.py's 256 inputs: the plain outputs of both variants
    against JAX fr.mul, square and pow7 (canonical values), and against
    Python ints (below 2p, congruent)."""
    av, bv = Pr.field_check_ints()
    a, b = fr._limb_tensor(av, "cpu"), fr._limb_tensor(bv, "cpu")
    ja = jnp.asarray(np.stack([jbn.int_to_limbs(v) for v in av], axis=1).astype(np.uint32))
    jb = jnp.asarray(np.stack([jbn.int_to_limbs(v) for v in bv], axis=1).astype(np.uint32))
    want = [jfr.to_ints(jfr.mul(ja, jb)), jfr.to_ints(jfr.square(ja)), jfr.to_ints(jfr.pow7(ja))]
    for variant in Pr.FIELD_VARIANTS:
        outs = Pr.field_check(a, b, variant)
        assert [fr.to_ints(o) for o in outs] == want
        assert Pr.field_check_values(av, bv, outs) == 0


def _redc(t: int) -> int:
    return (t + ((t * NPRIME) & _R_MASK) * P) >> 256


def test_mul_chain_plain_matches_python_ints():
    a, b = Pr.lazy_table(300, 1, "cpu"), Pr.lazy_table(300, 2, "cpu")
    steps = {
        "mul": lambda x, y: _redc(x * y),
        "mul_ptx": lambda x, y: _redc(x * y),
        "square": lambda x, y: _redc(x * x),
        "school": lambda x, y: ((x * y) & _R_MASK) ^ ((x * y) >> 256),
        "redc": lambda x, y: _redc(x + (y << 256)),
        "mul_fips": lambda x, y: _redc(x * y),
    }
    got = {v: _ints(Pr.mul_chain(a, b, v, 8)) for v in Pr.CHAIN_VARIANTS}
    for variant, step in steps.items():
        want = []
        for x, y in zip(_ints(a), _ints(b)):
            for _ in range(8):
                x = step(x, y)
            want.append(x)
        assert got[variant] == want, variant
    assert got["mul"] == got["mul_ptx"] == got["mul_fips"]
    assert _ints(Pr.mul_chain(a, a, "square", 1)) == _ints(Pr.mul_chain(a, a, "mul", 1))


def test_sbox_chain_matches_jax_scalar():
    x = fr._limb_tensor([0, 1, P - 1, 2 * P - 1] + _ints(Pr.lazy_table(3, 3, "cpu")), "cpu")
    want = []
    for v in _ints(x):
        v = v * RINV % P
        for _ in range(Pr.SBOX_ROUNDS):
            v = jscalar.pow7(v)
        want.append(v)
    for layout in Pr.LAYOUTS:
        got = Pr.sbox_chain(x, layout)
        assert fr.to_ints(got) == want
        assert all(v < P for v in _ints(got))  # canonical


def test_cipher_pe_variant_matches_jax_partial_evals():
    """n = 2^6, 9 evaluations, against the JAX package's portable round
    sums (sumcheck.prover._partial_evals, which its TPU kernels were held
    equal to)."""
    eq, x0, x1 = (Pr.lazy_table(64, s, "cpu") for s in (1, 2, 3))
    ark = fr.encode_mont_ints([145646], "cpu")
    got = Pr.cipher_pe_variant(eq, x0, x1, ark)
    assert got.shape == (8, 9, 1)
    jeq, jx0, jx1, jark = (jnp.asarray(to_jax_rows(t)) for t in (eq, x0, x1, ark))
    want = jsp._partial_evals(jgates.CipherGate(0), (jark[:, 0],), jeq, [jx0, jx1], None, False)
    assert fr.to_ints(got[:, :, 0].contiguous()) == jfr.to_ints(want)


def test_probe_wrappers_check_inputs():
    x, y = Pr.op_inputs((16, 64), "u32 mul", "cpu")
    with pytest.raises(ValueError):
        Pr.op_chain(x, y, "u64 mul", 1)
    with pytest.raises(TypeError):
        Pr.op_chain(x.float(), y.float(), "u32 mul", 1)
    with pytest.raises(ValueError):
        Pr.op_chain(x[:, :3].contiguous(), y[:, :3].contiguous(), "u32 mul", 1)
    with pytest.raises(ValueError):
        Pr.op_chain(x.t(), y.t(), "u32 mul", 1)
    m, xm = Pr.imma_inputs(64, "cpu")
    with pytest.raises(ValueError):
        Pr.imma_dot(m, xm, Pr.IMMA_MAX_REPS + 1)
    a = Pr.lazy_table(8, 1, "cpu")
    with pytest.raises(ValueError):
        Pr.mul_chain(a, a, "cube")
    with pytest.raises(ValueError):
        Pr.sbox_chain(a[:4].contiguous(), "col")
    with pytest.raises(ValueError):
        Pr.cipher_pe_variant(a, a, a, a[:, :1].contiguous(), threads=64)
    if not torch.cuda.is_available():  # the entry point needs the card
        with pytest.raises(RuntimeError):
            Pr.main(["micro_ops"])
    # the check that holds a probe to its plain version, and the SASS reader
    with pytest.raises(AssertionError):
        Pr.check("mul_chain", a, a ^ 1)
    assert Pr.check("mul_chain", a, a.clone()) == 0.0
    loop, whole = Pr.sass_loops(SASS_SAMPLE)["_Z15op_chain_kernelILi1EEvPKjS1_Pjli"]
    assert loop == ["IADD3", "IADD3", "ISETP.NE.AND", "BRA"] and len(whole) == 6


SASS_SAMPLE = """
        Function : _Z15op_chain_kernelILi1EEvPKjS1_Pjli
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   IADD3 R2, R2, R3, R3 ;
        /*0020*/                   IADD3 R4, R4, 0x10, RZ ;
        /*0030*/                   ISETP.NE.AND P0, PT, R4, R5, PT ;
        /*0040*/               @P0 BRA `(.L_x_1) ;
        /*0050*/                   EXIT ;
"""
