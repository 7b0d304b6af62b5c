"""The port's kernels (``repro_torch.kernels``) against the reference package.

On the CPU every wrapper runs its plain PyTorch version; those are held
against the reference's jnp oracles (``repro.kernels.ref``) and its Pallas
kernels in interpret mode, on the same numpy inputs made from a seed.  The
CUDA kernels themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.defense_sim import sketch_similarity as jax_sim_kernel
from repro.kernels.fedavg_agg import fedavg_agg as jax_agg_kernel
from repro.kernels.local_sgd import local_sgd_fused as jax_sgd_kernel
from repro.models import mnist as jmnist
from repro_torch.kernels import ops, ref
from repro_torch.kernels.defense_sim import sketch_similarity, split_chunk
from repro_torch.kernels.fedavg_agg import fedavg_agg
from repro_torch.kernels.local_sgd import local_sgd
from repro_torch.models import mnist as tmnist

I, H, C, B = 16, 8, 10, 20  # tiny MLP for the CPU


def sgd_inputs(R=4, n=37, seed=0):
    rng = np.random.default_rng(seed)
    D = H + C + I * H + H * C
    g = (rng.standard_normal(D) * 0.3).astype(np.float32)
    x = rng.random((R, n, I), dtype=np.float32)
    y = rng.integers(0, C, (R, n)).astype(np.int32)
    act = (np.arange(R) % 2).astype(np.int32)  # mixed ReLU / softmax
    mask = np.ones((R, n), bool)
    mask[1, 25:] = False  # ragged client
    mask[2, :] = False  # all-False client
    mask[3, :20] = False  # one all-padding batch
    return g, x, y, act, mask


def _jax_leaves(g):
    p = ref.split_flat(torch.as_tensor(g), I, H, C)
    return {k: jnp.asarray(v.numpy()) for k, v in p.items()}


def _jax_flat(new):
    R = new["b1"].shape[0]
    return np.concatenate(
        [np.asarray(new[k]).reshape(R, -1) for k in ("b1", "b2", "w1", "w2")], 1
    )


# ------------------------------------------------------------- fedavg_agg
@pytest.mark.parametrize("stale", [False, True])
def test_fedavg_agg_plain_matches_reference(stale):
    """fp32 sums over N in another order: atol = rtol = 1e-6."""
    rng = np.random.default_rng(1)
    d = rng.standard_normal((9, 517)).astype(np.float32)
    w = rng.random(9).astype(np.float32)
    tau = rng.integers(0, 5, 9).astype(np.float32) if stale else None
    got = ref.fedavg_agg_ref(torch.as_tensor(d), torch.as_tensor(w),
                             None if tau is None else torch.as_tensor(tau))
    want = jref.fedavg_agg_ref(jnp.asarray(d), jnp.asarray(w),
                               None if tau is None else jnp.asarray(tau))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    kern = jax_agg_kernel(jnp.asarray(d), jnp.asarray(w),
                          staleness=None if tau is None else jnp.asarray(tau),
                          interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- local_sgd
def test_local_sgd_plain_matches_reference_oracle():
    """Against ``repro.kernels.ref.local_sgd_ref`` (jax.grad), per client:
    mixed activations, ragged n under a mask, an all-False client and an
    all-padding batch.  fp32, a few steps: atol = rtol = 1e-5."""
    g, x, y, act, mask = sgd_inputs()
    got = ref.local_sgd_ref(torch.as_tensor(g), torch.as_tensor(x),
                            torch.as_tensor(y), torch.as_tensor(act),
                            torch.as_tensor(mask), hidden=H, classes=C,
                            lr=0.1, batch_size=B, epochs=2).numpy()
    p = _jax_leaves(g)
    one = functools.partial(jref.local_sgd_ref, lr=0.1, batch_size=B, epochs=2)
    for r in range(x.shape[0]):
        new = one(p["w1"], p["b1"], p["w2"], p["b2"], jnp.asarray(x[r]),
                  jnp.asarray(y[r]), jnp.asarray(act[r]), jnp.asarray(mask[r]))
        want = _jax_flat({k: np.asarray(v)[None] for k, v in new.items()})[0]
        np.testing.assert_allclose(got[r], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2], g)  # all-False client: unchanged


def test_local_sgd_plain_matches_pallas_interpret():
    """Against the Pallas ``local_sgd_fused`` in interpret mode at
    I = 16, H = 8, n = 40: atol = rtol = 1e-5 (fp32 reassociation)."""
    g, x, y, act, mask = sgd_inputs(n=40, seed=2)
    p = _jax_leaves(g)
    new = jax_sgd_kernel(p["w1"], p["b1"], p["w2"], p["b2"], jnp.asarray(x),
                         jnp.asarray(y), jnp.asarray(act), jnp.asarray(mask),
                         lr=0.1, batch_size=B, epochs=3, interpret=True)
    got = local_sgd(torch.as_tensor(g), torch.as_tensor(x), torch.as_tensor(y),
                    torch.as_tensor(act), torch.as_tensor(mask), hidden=H,
                    classes=C, lr=0.1, batch_size=B, epochs=3)
    np.testing.assert_allclose(got.numpy(), _jax_flat(new), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_longest_first_is_a_stable_descending_sort(seed):
    """The kernels' cluster order: clients by descending live-batch count,
    ties in client order, as numpy's stable sort of the negated counts."""
    from repro_torch.kernels.local_sgd import live_batches, longest_first

    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, 40).astype(np.int32)  # many ties
    got = longest_first(torch.as_tensor(counts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.argsort(-counts, kind="stable"))
    mask = rng.random((5, 57)) < 0.3
    mask[1] = False
    mask[2, 20:] = False
    want = [sum(mask[r, b:b + 20].any() for b in range(0, 57, 20)) for r in range(5)]
    np.testing.assert_array_equal(live_batches(torch.as_tensor(mask), 20).numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_model_local_sgd_matches_reference(masked):
    """``models.mnist.local_sgd`` (autograd) against the reference's
    ``models.mnist.local_sgd`` (jax.grad): the dense path floors the batch
    count (n = 50 -> 2 batches, the last 10 samples never train) and the
    masked path rounds it up (R5 in ROADMAP.md).  atol = rtol = 1e-5."""
    g, x, y, act, mask = sgd_inputs(n=50, seed=3)
    mask[2, :] = True  # keep every client live on this path
    params = {k: torch.as_tensor(v) for k, v in ref.split_flat(
        torch.as_tensor(g), I, H, C).items()}
    m = torch.as_tensor(mask) if masked else None
    got = tmnist.local_sgd(params, torch.as_tensor(x), torch.as_tensor(y),
                           lr=0.1, batch_size=B, epochs=2,
                           activation=torch.as_tensor(act), sample_mask=m)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    for r in range(x.shape[0]):
        want = jmnist.local_sgd(
            jp, jnp.asarray(x[r]), jnp.asarray(y[r]), lr=0.1, batch_size=B,
            epochs=2, activation=int(act[r]),
            sample_mask=jnp.asarray(mask[r]) if masked else None,
        )
        for k in want:
            np.testing.assert_allclose(got[k][r].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5)


# Kernels 1 and 4 take any hidden width up to 1,024 on the card: up to 256
# padding H to K slices of 16 columns where no portable split fits (H =
# 100, 200), past it the wide instance, w1 streamed from L2 through a ring
# (H = 257, its first width; 512; 879, the widest the reference's kernel
# takes at I = 784 and one sample; 1,024, its last); their plain versions
# are the CPU route and the card's yardstick.
WIDE = (100, 200, 256, 257, 512, 879, 1024)


def _wide_inputs(Hw, R=4, n=30, seed=5):
    """Both activations (clients alternate), a ragged tail, an all-masked
    batch and an all-False client at hidden width ``Hw``."""
    rng = np.random.default_rng(seed)
    D = Hw + C + I * Hw + Hw * C
    g = (rng.standard_normal(D) * 0.3).astype(np.float32)
    x = rng.random((R, n, I), dtype=np.float32)
    y = rng.integers(0, C, (R, n)).astype(np.int32)
    act = (np.arange(R) % 2).astype(np.int32)
    mask = np.ones((R, n), bool)
    mask[1, n - 7:] = False
    mask[2, :] = False
    mask[3, :10] = False
    return g, x, y, act, mask


def _split(g, Hw):
    p = ref.split_flat(torch.as_tensor(g), I, Hw, C)
    return {k: jnp.asarray(v.numpy()) for k, v in p.items()}


@pytest.mark.parametrize("Hw", WIDE)
def test_local_sgd_plain_matches_pallas_interpret_at_wide_hidden(Hw):
    """``local_sgd`` (on CPU tensors, its plain version) against the Pallas
    ``local_sgd_fused`` in interpret mode at H = 100 ... 879, B = 10,
    2 epochs: atol = rtol = 1e-5 (fp32 reassociation)."""
    g, x, y, act, mask = _wide_inputs(Hw)
    p = _split(g, Hw)
    new = jax_sgd_kernel(p["w1"], p["b1"], p["w2"], p["b2"], jnp.asarray(x),
                         jnp.asarray(y), jnp.asarray(act), jnp.asarray(mask),
                         lr=0.1, batch_size=10, epochs=2, interpret=True)
    got = local_sgd(torch.as_tensor(g), torch.as_tensor(x), torch.as_tensor(y),
                    torch.as_tensor(act), torch.as_tensor(mask), hidden=Hw,
                    classes=C, lr=0.1, batch_size=10, epochs=2)
    np.testing.assert_allclose(got.numpy(), _jax_flat(new), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), g)


@pytest.mark.parametrize("Hw", WIDE)
def test_local_sgd_ragged_plain_matches_pallas_interpret_at_wide_hidden(Hw):
    """``local_sgd_ragged`` (plain on the CPU) against the Pallas
    ``local_sgd_fused_ragged`` in interpret mode at H = 100 ... 879: the
    dense inputs cut into tiles of 10, client 1 with one tile fewer."""
    from repro.kernels.local_sgd import local_sgd_fused_ragged
    from repro_torch.kernels.local_sgd import local_sgd_ragged

    g, x, y, act, mask = _wide_inputs(Hw)
    R, n, _ = x.shape
    Bt = 10
    xt, yt, mt = x.reshape(-1, Bt, I), y.reshape(-1, Bt), mask.reshape(-1, Bt)
    nb = np.full(R, n // Bt, np.int32)
    nb[1] -= 1
    off = (np.arange(R) * (n // Bt)).astype(np.int32)
    arrays = (xt, yt, mt, act, nb, off)
    got = local_sgd_ragged(torch.as_tensor(g), *(torch.as_tensor(a) for a in arrays),
                           hidden=Hw, classes=C, lr=0.1, epochs=2)
    p = _split(g, Hw)
    pallas = local_sgd_fused_ragged(
        p["w1"], p["b1"], p["w2"], p["b2"], *(jnp.asarray(a) for a in arrays),
        lr=0.1, epochs=2, nb_max=int(nb.max()), interpret=True)
    np.testing.assert_allclose(got.numpy(), _jax_flat(pallas), rtol=1e-5, atol=1e-5)


# The wide instance's order of sums (csrc/local_sgd.cuh, local_sgd_wide_kernel),
# written out in torch: K slices of HS columns (64 up to H = 512, else 128),
# a CTA's 4 forward warps on HS / 32 column blocks; in a pass over the ring
# a warp row `wr` and lane row `rq` (row lane 4 wr + rq) take quad j * nrl
# + rl of I in chunk j; the forward sums a row lane's quads in chunk order,
# the four lane rows fold as (rq 0 + rq 2) + (rq 1 + rq 3), the warp rows
# meet in order; butterflies over 32 lanes for a slice's row max, exp-sum
# and softmax dot, the K slices in rank order; d hpre, the w2 gradient and
# the w1 update summed in batch-row order over the 20-row tile.
_KBT = 20


def _dot4(terms):
    """A sum in the kernel's dot4 order: four interleaved partial sums,
    combined as (s0 + s1) + (s2 + s3)."""
    s = [torch.zeros_like(terms[0]) for _ in range(4)]
    for k, v in enumerate(terms):
        s[k % 4] = s[k % 4] + v
    return (s[0] + s[1]) + (s[2] + s[3])


def _butterfly(v, op):
    """A warp butterfly over the last axis (32 lanes): every lane ends with
    the same value."""
    for o in (16, 8, 4, 2, 1):
        v = op(v, v[..., torch.arange(v.shape[-1]) ^ o])
    return v


def _lanes(h, nreal):
    """(rows, HS) -> (rows, 32 lanes, HS / 32): lane l holds columns l, l +
    32, ... of a slice, -inf past its model columns."""
    h = torch.where(torch.arange(h.shape[-1]) < nreal, h, torch.tensor(-torch.inf))
    return h.reshape(h.shape[0], -1, 32).transpose(1, 2)


def _wide_client(p, x, y, m, soft, Bw, epochs, lr):
    """One client's chain on the wide instance's plan, in its order of sums;
    returns the updated (w1, b1, w2, b2), float32."""
    Iw, Hw = p["w1"].shape
    Cw = p["b2"].shape[0]
    HS = 64 if -(-Hw // 64) <= 8 else 128
    K = -(-Hw // HS)
    nwr = 4 // (HS // 32)
    nrl = 4 * nwr
    quads = Iw // 4
    nch = -(-quads // nrl)
    Hp = K * HS
    w1 = torch.zeros(Iw, Hp)
    w1[:, :Hw] = p["w1"]
    b1 = torch.zeros(Hp)
    b1[:Hw] = p["b1"]
    w2 = torch.zeros(Hp, Cw)
    w2[:Hw] = p["w2"]
    b2 = p["b2"].clone()
    nreal = [min(HS, Hw - k * HS) for k in range(K)]
    n = x.shape[0]
    nb = -(-n // Bw)
    xp = torch.zeros(nb * Bw + _KBT, Iw)
    xp[:n] = x
    yp = torch.zeros(nb * Bw, dtype=torch.int64)
    yp[:n] = y
    mp = torch.zeros(nb * Bw)
    mp[:n] = m

    def tile(t):
        xt = torch.zeros(_KBT, Iw)
        xt[:Bw] = xp[t % nb * Bw:(t % nb + 1) * Bw]
        return xt

    def forward(xt):
        acc = torch.zeros(nwr, 4, _KBT, Hp)
        for j in range(nch):
            for wr in range(nwr):
                for rq in range(4):
                    q = j * nrl + 4 * wr + rq
                    if q < quads:
                        for e in range(4):
                            i = 4 * q + e
                            acc[wr, rq] = acc[wr, rq] + xt[:, i:i + 1] * w1[i]
        v = (acc[:, 0] + acc[:, 2]) + (acc[:, 1] + acc[:, 3])
        s = v[0]
        for wr in range(1, nwr):
            s = s + v[wr]
        return s + b1

    live = [t for t in range(epochs * nb) if mp[t % nb * Bw:(t % nb + 1) * Bw].sum() > 0]
    hpre = forward(tile(live[0])) if live else None
    for step, t in enumerate(live):
        xt = tile(t)
        rows = slice(t % nb * Bw, (t % nb + 1) * Bw)
        if soft:
            hact = torch.zeros(_KBT, Hp)
            mk, sk = [], []
            for k in range(K):
                hl = _lanes(hpre[:Bw, k * HS:(k + 1) * HS], nreal[k])
                mx = _butterfly(hl.amax(-1), torch.maximum)[:, 0]
                e = torch.exp(hl - mx[:, None, None])
                lane = torch.zeros(Bw, 32)
                for c in range(e.shape[-1]):
                    lane = lane + e[..., c]
                mk.append(mx)
                sk.append(_butterfly(lane, torch.add)[:, 0])
            M = mk[0]
            for mx in mk[1:]:
                M = torch.maximum(M, mx)
            S = torch.zeros(Bw)
            for mx, sm in zip(mk, sk):
                S = S + sm * torch.exp(mx - M)
            for k in range(K):
                cols = slice(k * HS, k * HS + nreal[k])
                hact[:Bw, cols] = torch.exp(hpre[:Bw, cols] - M[:, None]) / S[:, None]
        else:
            hact = torch.relu(hpre)
        logits = None
        for k in range(K):
            cols = range(k * HS, (k + 1) * HS)
            part = _dot4([hact[:Bw, h:h + 1] * w2[h] for h in cols])
            logits = part if logits is None else logits + part
        logits = logits + b2
        # a quarter warp a row: lane l8 holds classes l8 and l8 + 8
        lv = torch.full((Bw, 16), -torch.inf)
        lv[:, :Cw] = logits
        q8 = torch.maximum(lv[:, :8], lv[:, 8:])
        for o in (4, 2, 1):
            q8 = torch.maximum(q8, q8[:, torch.arange(8) ^ o])
        e = torch.exp(lv - q8[:, :1])
        s8 = e[:, :8] + e[:, 8:]
        for o in (4, 2, 1):
            s8 = s8 + s8[:, torch.arange(8) ^ o]
        onehot = torch.nn.functional.one_hot(yp[rows], 16).to(torch.float32)
        cnt = torch.clamp(mp[rows].sum(), min=1.0)
        lg = ((e / s8[:, :1] - onehot) * (mp[rows] / cnt)[:, None])[:, :Cw]
        dh = torch.zeros(_KBT, Hp)
        for c in range(Cw):
            dh[:Bw] = dh[:Bw] + lg[:, c:c + 1] * w2[:, c]
        gw2 = torch.zeros(Hp, Cw)
        for b in range(Bw):
            gw2 = gw2 + hact[b][:, None] * lg[b]
        b2 = b2 - lr * _dot4([lg[b] for b in range(Bw)])
        if soft:
            dots = []
            for k in range(K):
                prod = (dh[:Bw] * hact[:Bw])[:, k * HS:(k + 1) * HS]
                prod = prod.reshape(Bw, -1, 32).transpose(1, 2)
                lane = torch.zeros(Bw, 32)
                for c in range(prod.shape[-1]):
                    lane = lane + prod[..., c]
                dots.append(_butterfly(lane, torch.add)[:, 0])
            dot = dots[0]
            for d in dots[1:]:
                dot = dot + d
            dpp = torch.zeros(_KBT, Hp)
            dpp[:Bw] = hact[:Bw] * (dh[:Bw] - dot[:, None])
        else:
            dpp = torch.where(hpre > 0, dh, torch.zeros(()))
            dpp[Bw:] = 0.0
        w2 = w2 - lr * gw2
        b1 = b1 - lr * _dot4([dpp[b] for b in range(Bw)])
        g1 = torch.zeros(Iw, Hp)
        for b in range(_KBT):
            g1 = g1 + xt[b][:, None] * dpp[b]
        w1 = w1 - lr * g1
        if step + 1 < len(live):
            hpre = forward(tile(live[step + 1]))
    return w1[:, :Hw], b1[:Hw], w2[:Hw], b2


def test_wide_instance_order_of_sums_matches_pallas_and_float64():
    """The wide instance's order of sums (``_wide_client``) at I = 96 (24
    quads: three ring chunks of 8 at HS = 64), H = 300 (5 slices of 64, the
    last with 44 model columns), B = 10 (rows 10-19 of the tile zero), 2
    epochs, both activations, a ragged tail, an all-masked batch and an
    all-False client: within atol = rtol = 1e-5 of the Pallas kernel in
    interpret mode and of the plain version run in float64."""
    Iw, Hw, Bw = 96, 300, 10
    rng = np.random.default_rng(32)
    R, n = 4, 30
    D = Hw + C + Iw * Hw + Hw * C
    g = (rng.standard_normal(D) * 0.3).astype(np.float32)
    x = rng.random((R, n, Iw), dtype=np.float32)
    y = rng.integers(0, C, (R, n)).astype(np.int32)
    act = (np.arange(R) % 2).astype(np.int32)
    mask = np.ones((R, n), bool)
    mask[1, n - 7:] = False
    mask[2, :] = False
    mask[3, :10] = False
    p = ref.split_flat(torch.as_tensor(g), Iw, Hw, C)
    rows = []
    for r in range(R):
        w1, b1, w2, b2 = _wide_client(p, torch.as_tensor(x[r]), torch.as_tensor(y[r]),
                                      torch.as_tensor(mask[r], dtype=torch.float32),
                                      bool(act[r]), Bw, 2, 0.1)
        rows.append(torch.cat([b1, b2, w1.reshape(-1), w2.reshape(-1)]))
    emu = torch.stack(rows).numpy()
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    pallas = jax_sgd_kernel(jp["w1"], jp["b1"], jp["w2"], jp["b2"], jnp.asarray(x),
                            jnp.asarray(y), jnp.asarray(act), jnp.asarray(mask),
                            lr=0.1, batch_size=Bw, epochs=2, interpret=True)
    np.testing.assert_allclose(emu, _jax_flat(pallas), rtol=1e-5, atol=1e-5)
    f64 = ref.local_sgd_ref(*(torch.as_tensor(a) for a in (g, x, y, act, mask)), hidden=Hw,
                            classes=C, lr=0.1, batch_size=Bw, epochs=2, dtype=torch.float64)
    np.testing.assert_allclose(emu, f64.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(emu[2], g)


# Past the narrow and wide plans the card runs the general instance: any
# batch, class count and input width of the reference's envelope
# (``fused_fits_vmem``), of which the port keeps its own copy.
def test_fused_fits_vmem_copy_equals_reference():
    """The port's ``fused_fits_vmem`` (no JAX in the port) gives the
    reference's answer on a seeded grid of shapes around the envelope's
    edge, its corners among them, and takes the same budget."""
    from repro.kernels import local_sgd as jls
    from repro_torch.kernels import local_sgd as tls

    assert tls.VMEM_BUDGET_BYTES == jls.VMEM_BUDGET_BYTES
    rng = np.random.default_rng(30)
    shapes = list(zip(rng.integers(1, 3000, 3000), rng.integers(1, 1025, 3000),
                      rng.integers(1, 30001, 3000), rng.integers(1, 5000, 3000)))
    shapes += [(2279, 784, 128, 10), (2280, 784, 128, 10), (20, 784, 128, 4611),
               (20, 784, 128, 4612), (20, 16, 26209, 10), (20, 16, 26210, 10),
               (20, 784, 873, 10), (20, 784, 874, 10)]
    got = [tls.fused_fits_vmem(*map(int, s)) for s in shapes]
    assert got == [jls.fused_fits_vmem(*map(int, s)) for s in shapes]
    assert 0 < sum(got) < len(got)
    assert tls.fused_fits_vmem(1000, 784, 128, 10, budget=1 << 20) is False


# (batch, classes, input width) past what the narrow and wide plans take
GENERAL = [(40, C, I), (B, 47, I), (B, C, 13)]


def _general_inputs(Bg, Cg, Ig, R=4, seed=7):
    rng = np.random.default_rng(seed)
    n = 2 * Bg + 9
    D = H + Cg + Ig * H + H * Cg
    g = (rng.standard_normal(D) * 0.3).astype(np.float32)
    x = rng.random((R, n, Ig), dtype=np.float32)
    y = rng.integers(0, Cg, (R, n)).astype(np.int32)
    act = (np.arange(R) % 2).astype(np.int32)
    mask = np.ones((R, n), bool)
    mask[1, n - 5:] = False
    mask[2, :] = False
    mask[3, :Bg] = False
    return g, x, y, act, mask


@pytest.mark.parametrize("Bg,Cg,Ig", GENERAL)
def test_local_sgd_plain_matches_reference_oracle_past_the_fixed_plans(Bg, Cg, Ig):
    """``ref.local_sgd_ref`` and ``ref.local_sgd_ragged_ref`` against the
    reference's oracle (``repro.kernels.ref.local_sgd_ref``, jax.grad),
    client by client, at B = 40, C = 47 and I = 13 (H = 8): both
    activations, a partial last batch, an all-False client and an
    all-padding batch.  fp32, a few steps: atol = rtol = 1e-5."""
    g, x, y, act, mask = _general_inputs(Bg, Cg, Ig)
    R, n, _ = x.shape
    kw = dict(hidden=H, classes=Cg, lr=0.1, epochs=2)
    dense = ref.local_sgd_ref(*(torch.as_tensor(a) for a in (g, x, y, act, mask)),
                              batch_size=Bg, **kw).numpy()
    nbk = -(-n // Bg)
    pad = nbk * Bg - n
    xt = np.pad(x, ((0, 0), (0, pad), (0, 0))).reshape(-1, Bg, Ig)
    yt = np.pad(y, ((0, 0), (0, pad))).reshape(-1, Bg)
    mt = np.pad(mask, ((0, 0), (0, pad))).reshape(-1, Bg)
    nb = np.full(R, nbk, np.int32)
    off = (np.arange(R) * nbk).astype(np.int32)
    ragged = ref.local_sgd_ragged_ref(
        torch.as_tensor(g), *(torch.as_tensor(a) for a in (xt, yt, mt, act, nb, off)),
        **kw).numpy()
    p = ref.split_flat(torch.as_tensor(g), Ig, H, Cg)
    p = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    for r in range(R):
        new = jref.local_sgd_ref(p["w1"], p["b1"], p["w2"], p["b2"], jnp.asarray(x[r]),
                                 jnp.asarray(y[r]), jnp.asarray(act[r]),
                                 jnp.asarray(mask[r]), lr=0.1, batch_size=Bg, epochs=2)
        want = _jax_flat({k: np.asarray(v)[None] for k, v in new.items()})[0]
        np.testing.assert_allclose(dense[r], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ragged[r], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(dense[2], g)
    np.testing.assert_array_equal(ragged[2], g)


# The batches the card's tiled plan takes (past 20 rows, in sub-tiles of up
# to 20): the paper's Fig. 6 point B = 40 and one full 200-sample batch,
# at I = 16, H = 16 (two 8-column slices on the card)
TILED_BATCHES = (40, 200)


@pytest.mark.parametrize("form", ["dense", "ragged"])
@pytest.mark.parametrize("Bt", TILED_BATCHES)
def test_local_sgd_plain_matches_pallas_interpret_at_tiled_batches(Bt, form):
    """``local_sgd`` / ``local_sgd_ragged`` (plain on the CPU) against the
    Pallas ``local_sgd_fused`` / ``local_sgd_fused_ragged`` in interpret
    mode at B = 40 and 200 (I = 16, H = 16, C = 10, 2 epochs): both
    activations, a partial last batch, an all-masked client and an
    all-masked batch; the ragged buffer is the dense batches client after
    client.  atol = rtol = 1e-5: fp32 sums of up to B = 200 terms taken in
    another order than XLA's, over a few steps."""
    from repro.kernels.local_sgd import local_sgd_fused_ragged
    from repro_torch.kernels.local_sgd import local_sgd_ragged

    Ht = 16
    rng = np.random.default_rng(31)
    R, n = 4, 2 * Bt + 17
    D = Ht + C + I * Ht + Ht * C
    g = (rng.standard_normal(D) * 0.3).astype(np.float32)
    x = rng.random((R, n, I), dtype=np.float32)
    y = rng.integers(0, C, (R, n)).astype(np.int32)
    act = (np.arange(R) % 2).astype(np.int32)
    mask = np.ones((R, n), bool)
    mask[1, n - 5:] = False
    mask[2, :] = False
    mask[3, Bt:2 * Bt] = False
    p = _split(g, Ht)
    if form == "dense":
        got = local_sgd(*(torch.as_tensor(a) for a in (g, x, y, act, mask)), hidden=Ht,
                        classes=C, lr=0.1, batch_size=Bt, epochs=2)
        want = jax_sgd_kernel(p["w1"], p["b1"], p["w2"], p["b2"], jnp.asarray(x),
                              jnp.asarray(y), jnp.asarray(act), jnp.asarray(mask),
                              lr=0.1, batch_size=Bt, epochs=2, interpret=True)
    else:
        nbk = -(-n // Bt)
        pad = nbk * Bt - n
        xt = np.pad(x, ((0, 0), (0, pad), (0, 0))).reshape(-1, Bt, I)
        yt = np.pad(y, ((0, 0), (0, pad))).reshape(-1, Bt)
        mt = np.pad(mask, ((0, 0), (0, pad))).reshape(-1, Bt)
        nb = np.full(R, nbk, np.int32)
        off = (np.arange(R) * nbk).astype(np.int32)
        arrays = (xt, yt, mt, act, nb, off)
        got = local_sgd_ragged(torch.as_tensor(g), *(torch.as_tensor(a) for a in arrays),
                               hidden=Ht, classes=C, lr=0.1, epochs=2)
        want = local_sgd_fused_ragged(
            p["w1"], p["b1"], p["w2"], p["b2"], *(jnp.asarray(a) for a in arrays),
            lr=0.1, epochs=2, nb_max=nbk, interpret=True)
    np.testing.assert_allclose(got.numpy(), _jax_flat(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), g)


# ------------------------------------------------------- sketch_similarity
def test_sketch_similarity_plain_matches_reference():
    """M != N and K = 300, not a multiple of 128: fp32 dot products,
    atol = rtol = 1e-5; the Pallas kernel (interpret) pads and slices."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((5, 300)).astype(np.float32)
    b = rng.standard_normal((7, 300)).astype(np.float32)
    got = ref.sketch_similarity_ref(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert got.shape == (5, 7)
    np.testing.assert_allclose(got, np.asarray(jref.sketch_similarity_ref(a, b)),
                               rtol=1e-5, atol=1e-5)
    kern = jax_sim_kernel(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n,k,splits", [
    (12, 12, 256, 1), (512, 512, 256, 1), (12, 12, 101770, 245), (5, 7, 300, 2),
])
def test_split_chunk_plan(m, n, k, splits):
    """The K split the similarity kernel uses: whole 32-wide pipeline
    slices, no split under 256 wide, about two blocks per SM for a small
    output."""
    chunk = split_chunk(m, n, k)
    assert chunk % 32 == 0 and chunk >= 256
    assert -(-k // chunk) == splits


# ----------------------------------------------------------------- routing
def test_resolve_impl_routes_by_device():
    assert ops.resolve_impl("auto", "sgd", "cpu") == "einsum"
    assert ops.resolve_impl("einsum", "agg", "cpu") == "einsum"
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.resolve_impl("kernel", "defense", "cpu")
    with pytest.raises(ValueError):
        ops.resolve_impl("pallas", "agg", "cpu")
    with pytest.raises(ValueError):
        ops.resolve_impl("auto", "attention", "cpu")


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    before = (local_sgd.launches, fedavg_agg.launches, sketch_similarity.launches)
    g, x, y, act, mask = (torch.as_tensor(a) for a in sgd_inputs(seed=5))
    kw = dict(hidden=H, classes=C, lr=0.05, batch_size=B, epochs=1)
    assert torch.equal(local_sgd(g, x, y, act, mask, **kw),
                       ref.local_sgd_ref(g, x, y, act, mask, **kw))
    d, w = torch.randn(6, 40), torch.rand(6)
    assert torch.equal(fedavg_agg(d, w), ref.fedavg_agg_ref(d, w))
    assert torch.equal(sketch_similarity(d, d), ref.sketch_similarity_ref(d, d))
    assert (local_sgd.launches, fedavg_agg.launches,
            sketch_similarity.launches) == before
