"""cmfrec_torch's K1 probes (CPU path = their plain versions) against the
TPU probes of the Pallas K1 body.

The TPU probe bodies are closures inside each script's main() that print
only times, so they cannot be called here.  Where a body computes K1 on a
0/1 mask (p_full, p_part, v0, vw16, vsel, vbf, vbig) the probe is held
against cmfrec_tpu's masked_gram_matvec in interpret mode; every other
body against a jnp transcription of its lines, cast points included,
cited beside it.  R = BLOCK_R, K = 64.

Tolerances, as max|out - ref| <= tol * max|ref|:
  * bodies that round T or T*W to bf16: 1e-3 (a rounding may flip by one
    bf16 ulp when T's f32 sum differs in its last bits, as for K1);
  * p_dot1, the f32 row sums of T: 1e-5 (summation order);
  * the W stream: exact on a 0/1 mask, 1e-6 on bf16 weights (f32
    summation order);
  * p_part's plain version against K1's own twin: 1e-6 (the same rounded
    products, the second product summed by chunks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmfrec_tpu.ops import masked_matmul as jmm
from cmfrec_torch.ops import k1_probes as kp
from cmfrec_torch.ops import masked_matmul as tmm

K = 64
R = jmm.BLOCK_R
TOL = 1e-3
PROBES = {p.name: p for p in kp.PROBES}


def _rel_err(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _operands(seed, S, w="int8"):
    """torch (Q, Be, W) and the same values as JAX arrays; W a 0/1 mask in
    int8 ("int8") or bf16 ("bf16"), or bf16 weights ("weights")."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(R, K)).astype(np.float32)
    Be = rng.normal(size=(S, K)).astype(np.float32)
    mask = rng.uniform(size=(R, S)) < 0.3
    if w == "weights":
        Wn = (mask * rng.uniform(0.5, 2.0, size=(R, S))).astype(np.float32)
    else:
        Wn = mask.astype(np.float32)
    Wt = torch.from_numpy(Wn).to(torch.int8 if w == "int8" else torch.bfloat16)
    Wj = jnp.asarray(Wn, jnp.int8 if w == "int8" else jnp.bfloat16)
    Qt = torch.from_numpy(Q).to(torch.bfloat16)
    Bet = torch.from_numpy(Be).to(torch.bfloat16)
    return (Qt, Bet, Wt), (jnp.asarray(Q, jnp.bfloat16),
                           jnp.asarray(Be, jnp.bfloat16), Wj)


# --- the TPU bodies, transcribed (whole arrays instead of grid blocks)

def p_dots(q, be, w):  # sweep_kernel_probe2.py:54-58
    t = jnp.dot(q, be.T, preferred_element_type=jnp.float32)
    return jnp.dot(t.astype(jnp.bfloat16), be,
                   preferred_element_type=jnp.float32)


def p_dot1(q, be, w):  # sweep_kernel_probe2.py:60-64
    t = jnp.dot(q, be.T, preferred_element_type=jnp.float32)
    return jnp.sum(t, axis=1, keepdims=True) * jnp.ones((1, K), jnp.float32)


# sweep_kernel_probe2.py:66-69; sweep_kernel_probe3.py:83-86 is the same
def p_wsum(q, be, w):
    w = w.astype(jnp.float32)
    return jnp.sum(w, axis=1, keepdims=True) * jnp.ones((1, K), jnp.float32)


def p_part(q, be, w, bs):  # sweep_kernel_probe2.py:88-93, summed as at :148
    def body(be_j, w_j):
        t = jnp.dot(q, be_j.T, preferred_element_type=jnp.float32)
        t = (t * w_j.astype(jnp.float32)).astype(jnp.bfloat16)
        return jnp.dot(t, be_j, preferred_element_type=jnp.float32)[:, None, :]

    parts = [body(be[j:j + bs], w[:, j:j + bs])
             for j in range(0, be.shape[0], bs)]
    return jnp.sum(jnp.concatenate(parts, axis=1), axis=1)


def vbf(q, be, w):  # sweep_kernel_variants.py:54-58
    t = jnp.dot(q, be.T, preferred_element_type=jnp.bfloat16)
    t = t * w.astype(jnp.bfloat16)
    return jnp.dot(t, be, preferred_element_type=jnp.float32)


def vsel(q, be, w):  # sweep_kernel_variants.py:61-65
    t = jnp.dot(q, be.T, preferred_element_type=jnp.bfloat16)
    t = jnp.where(w != 0, t, jnp.bfloat16(0))
    return jnp.dot(t, be, preferred_element_type=jnp.float32)


# ---

K1_BODIES = [p.name for p in kp.PROBES if p.work == "k1"]


@pytest.mark.parametrize("S", [1024, 2048])
@pytest.mark.parametrize("name", K1_BODIES)
def test_k1_bodies_match_pallas_on_a_mask(name, S):
    """p_full, p_part, v0, vbf, vsel, vw16 and vbig on a 0/1 mask are K1."""
    probe = PROBES[name]
    w = "int8" if probe.w_dtype == torch.int8 else "bf16"
    (Q, Be, W), (Qj, Bej, Wj) = _operands(1, S, w)
    out = probe.kernel(Q, Be, W)
    assert out.dtype == torch.float32 and tuple(out.shape) == (R, K)
    ref = jmm.masked_gram_matvec(Qj, Bej, Wj, block_s=1024, interpret=True)
    assert _rel_err(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("S", [1024, 2048])
@pytest.mark.parametrize("name,body,tol", [
    ("p_dots", p_dots, TOL), ("p_dot1", p_dot1, 1e-5), ("p_wsum", p_wsum, 0.0),
])
def test_p1_bodies_match_their_transcriptions(name, body, tol, S):
    (Q, Be, W), jargs = _operands(2, S)
    out = PROBES[name].kernel(Q, Be, W)
    assert tuple(out.shape) == (R, K)
    assert _rel_err(out.numpy(), body(*jargs)) <= tol


@pytest.mark.parametrize("chunk", [256, 1024, kp.PART_CHUNK])
def test_p_part_matches_its_transcription_and_k1(chunk):
    S = 2048
    (Q, Be, W), jargs = _operands(3, S)
    out = kp.part(Q, Be, W, chunk=chunk)
    assert _rel_err(out.numpy(), p_part(*jargs, bs=min(chunk, S))) <= TOL
    assert _rel_err(out.numpy(), tmm.masked_gram_matvec_ref(Q, Be, W)) <= 1e-6


@pytest.mark.parametrize("name,body,warps", [
    ("vbf", vbf, 4), ("vbf", vbf, 8), ("vsel", vsel, 4)])
def test_p2_bodies_match_their_transcriptions_on_weights(name, body, warps):
    """vbf (and vbig, its 128-row blocks) and vsel on bf16 weights, where
    they differ from K1."""
    (Q, Be, W), jargs = _operands(4, 1024, "weights")
    out = (kp.bft(Q, Be, W, warps=warps) if name == "vbf"
           else kp.sel(Q, Be, W))
    assert _rel_err(out.numpy(), body(*jargs)) <= TOL
    # vbf on weights is K1 with a bf16 W (the TPU's bf16 multiply, :94)
    if name == "vbf":
        ref = jmm.masked_gram_matvec(*jargs, block_s=1024, interpret=True)
        assert _rel_err(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("tile", kp.W_STREAM_TILES)
@pytest.mark.parametrize("w", ["int8", "bf16", "weights"])
def test_w_stream_matches_make_wsum(tile, w):
    (_, _, W), (_, _, Wj) = _operands(5, 1024, w)
    out = kp.w_stream(W, K, tile)
    assert tuple(out.shape) == (R, K) and out.is_contiguous()
    tol = 1e-6 if w == "weights" else 0.0
    assert _rel_err(out.numpy(), p_wsum(None, None, Wj)) <= tol


def test_cpu_tensors_launch_nothing():
    (Q, Be, W), _ = _operands(6, 1024)
    for probe in kp.PROBES:
        probe.kernel(Q, Be, W.to(probe.w_dtype))
    assert [w.launches for w in kp.WRAPPERS] == [0] * len(kp.WRAPPERS)


def _t(shape, dtype):
    return torch.zeros(shape, dtype=dtype)


bf, i8 = torch.bfloat16, torch.int8


@pytest.mark.parametrize("call,match", [
    (lambda: kp.dots(_t((64, 64), torch.float32), _t((64, 64), torch.float32),
                     _t((64, 64), i8)), "bfloat16 Q and Be"),
    (lambda: kp.sel(_t((64, 64), bf), _t((64, 64), bf),
                    _t((64, 64), torch.float32)), "W must be int8"),
    (lambda: kp.dot1(_t((64, 64), bf), _t((64, 128), bf), _t((64, 64), i8)),
     "one width"),
    (lambda: kp.wsum(_t((96, 64), bf), _t((64, 64), bf), _t((96, 64), i8)),
     "multiples"),
    (lambda: kp.bft(_t((64, 64), bf), _t((64, 64), bf), _t((64, 64), i8),
                    warps=2), "warps=2"),
    (lambda: kp.part(_t((64, 64), bf), _t((64, 64), bf), _t((64, 64), i8),
                     chunk=100), "chunk=100"),
    (lambda: kp.w_stream(_t((64, 64), i8), 64, (32, 32)), "not built"),
    (lambda: kp.w_stream(_t((64, 64), torch.float32), 64), "W must be"),
    (lambda: kp.w_stream(_t((64, 96), i8), 64), "multiples"),
    (lambda: kp.w_stream(_t((64, 64), i8), 0), "K=0"),
])
def test_probes_reject(call, match):
    with pytest.raises(ValueError, match=match):
        call()
