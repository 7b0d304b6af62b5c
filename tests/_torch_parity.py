"""Shared harness of the port's parity tests: one config through the live
reference engine and through the port, on the same data, init params and
draws.

The reference's threefry draws (``fold_in(PRNGKey(seed), round)``, a 3-way
split for selection / latency, for QSGD a ``0xC0DEC`` fold of the round key
then one fold per client id, and for the fault schedule one (n, 2) uniform
table of the ``0xFA017`` fold) are made here with JAX and replayed into the
port through ``convert.ReplayDraws``.  ``run_cohort_both`` does the same for
the cohort engine, whose sub-engine draws at ``(seed, round)`` for K slots.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.fedar_mnist import fleet_fed as jfleet_fed
from repro.configs.fedar_mnist import small_model as jsmall_model
from repro.core.compress import client_keys
from repro.core.engine import CohortEngine as JCohortEngine
from repro.core.engine import FedAREngine as JEngine
from repro.core.resources import TaskRequirement as JReq
from repro.data.datasets import VirtualFleet as JVirtualFleet
from repro.data.datasets import make_federated
from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.convert import ReplayDraws, params_from_jax
from repro_torch.core.engine import CohortEngine
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import LATENCY_JITTER, TaskRequirement
from repro_torch.data.datasets import VirtualFleet
from repro_torch.data.federated import table2_fleet

COMPRESS_KEY_FOLD = 0xC0DEC  # repro/core/engine.py's domain separator
FAULT_KEY_FOLD = 0xFA017  # repro/core/faults.py's


def reference_draws(seed, rounds, n, dim=None, faults=False):
    """``ReplayDraws`` keyword arguments: the (rounds, n) Gumbel draws and
    latency factors ``exp(LATENCY_JITTER * normal)``, plus the (rounds, n, dim)
    QSGD uniforms when ``dim`` is given and the (rounds, n, 2) fault coins
    when ``faults``.  The factor is one jitted
    computation, as inside the reference engine's jitted round: XLA folds
    the jitter into the normal's own scale there, which rounds otherwise
    than an eager ``normal`` followed by ``exp``."""
    factor = jax.jit(lambda k: jnp.exp(LATENCY_JITTER * jax.random.normal(k, (n,))))
    g, lat, u, f = [], [], [], []
    for r in range(rounds):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), r)
        k_sel, k_lat, _ = jax.random.split(key, 3)
        g.append(np.asarray(jax.random.gumbel(k_sel, (n,))))
        lat.append(np.asarray(factor(k_lat)))
        if dim is not None:
            keys = client_keys(jax.random.fold_in(key, COMPRESS_KEY_FOLD),
                               jnp.arange(n, dtype=jnp.int32))
            u.append(np.asarray(
                jax.vmap(lambda k: jax.random.uniform(k, (dim,)))(keys)))
        if faults:
            f.append(np.asarray(jax.random.uniform(
                jax.random.fold_in(key, FAULT_KEY_FOLD), (n, 2))))
    return dict(gumbel=np.stack(g), latency=np.stack(lat),
                uniform=np.stack(u) if dim is not None else None,
                faults=np.stack(f) if faults else None)


def run_both(rounds, *, hidden=32, samples=60, force=None, **overrides):
    """The golden-size config (12 robots, Table II with ``samples`` each,
    ``small_model(hidden)``) with ``overrides`` through both engines for
    ``rounds`` rounds, ``force`` (12,) bool marking forced stragglers.
    Returns (reference state, reference outputs, port server, port
    history)."""
    jeng = JEngine(jsmall_model(hidden), jfleet_fed(12, **overrides), JReq())
    ds = make_federated("table2", 12, samples_per_client=samples)
    ev = (ds.x[0, :50], ds.y[0, :50])
    jforce = None if force is None else jnp.asarray(force)
    jstate, jouts = jeng.run(
        jeng.init_state(), {k: jnp.asarray(v) for k, v in ds.arrays().items()},
        rounds=rounds, eval_set=(jnp.asarray(ev[0]), jnp.asarray(ev[1])),
        force_straggler=jforce,
    )
    params, _ = params_from_jax(jeng.template)
    needs_unif = overrides.get("compress") == "qsgd"
    draws = ReplayDraws(**reference_draws(
        0, rounds, 12, jeng.dim if needs_unif else None,
        faults=overrides.get("faults", "none") != "none"))
    server = FedARServer(
        small_model(hidden), fleet_fed(12, **overrides), TaskRequirement(),
        device="cpu", draws=draws, init_params=params,
    )
    hist = server.run(table2_fleet(samples_per_client=samples), rounds=rounds,
                      eval_set=ev, force_straggler=force)
    return jstate, jouts, server, hist


def assert_bookkeeping_equal(jstate, jouts, server, hist):
    """Trust, the selected / on-time masks, the participation counters, the
    battery and the async slot bookkeeping: exactly equal."""
    np.testing.assert_array_equal(np.stack(hist["trust"]), np.asarray(jouts.trust))
    np.testing.assert_array_equal(np.stack(hist["selected"]),
                                  np.asarray(jouts.selected))
    np.testing.assert_array_equal(np.stack(hist["on_time"]),
                                  np.asarray(jouts.on_time))
    np.testing.assert_array_equal(np.asarray(hist["round_time"], np.float32),
                                  np.asarray(jouts.round_time))
    st = server.state
    for name in ("participations", "failures"):
        np.testing.assert_array_equal(getattr(st.trust, name).numpy(),
                                      np.asarray(getattr(jstate.trust, name)))
    np.testing.assert_array_equal(st.resources.battery.numpy(),
                                  np.asarray(jstate.resources.battery))
    for name in ("pending_issued", "pending_arrival", "pending_valid"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jstate, name)))
    assert st.pending_delta.shape == jstate.pending_delta.shape
    assert st.compress_residual.shape == jstate.compress_residual.shape


def assert_close_up_to_flips(name, got, want, *, level, max_share):
    """``got`` within atol = rtol = 2e-4 of ``want`` on all but at most
    ``max_share`` of the elements (at least one element is allowed), and
    every element within ``level`` + 2e-4.

    Why: local SGD differs between JAX and torch by ~1e-7, so a QSGD code
    whose uniform lies within that distance of ``u - floor(u)`` rounds the
    other way in one of them and moves its element by one level
    (``scale / L``); a tie in |v| at top-k's k-th place keeps another
    index, moving two elements by one dropped value.  A flipped code that
    reaches the aggregate moves that params element by its weight share of
    one level, which is at most one level."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want)
    over = int((err > 2e-4 + 2e-4 * np.abs(want)).sum())
    allowed = max(1, int(max_share * want.size))
    assert over <= allowed, f"{name}: {over} elements off, at most {allowed} may be"
    assert err.max(initial=0.0) <= level + 2e-4, (
        f"{name}: max error {err.max()} beyond one level {level}")


def cohort_draws(jeng, rounds, overrides):
    """``ReplayDraws`` for a cohort run: the sub-engine's draws, keyed on
    the store's absolute round, for K slots."""
    k = jeng.fed.cohort_size
    dim = jeng.dim if overrides.get("compress") == "qsgd" else None
    return ReplayDraws(**reference_draws(
        jeng.fed.seed, rounds, k, dim,
        faults=overrides.get("faults", "none") != "none"))


def run_cohort_both(rounds, *, n=48, k=12, hidden=32, samples=60, **overrides):
    """The reference's ``CohortEngine`` and the port's on the same
    ``VirtualFleet(n, samples_per_client=samples)``, ``small_model(hidden)``,
    cohort size ``k`` and ``overrides``, from the reference's init params
    with its replayed draws, for ``rounds`` rounds.  Returns (reference
    engine, its per-round outputs, port engine, its per-round outputs);
    each output is ``(idx, valid, RoundOutputs)``."""
    jeng = JCohortEngine(jsmall_model(hidden),
                         jfleet_fed(n, cohort_size=k, **overrides), JReq())
    jouts = jeng.run(JVirtualFleet(n, samples_per_client=samples),
                     rounds=rounds)
    params, _ = params_from_jax(jeng.template)
    eng = CohortEngine(small_model(hidden), fleet_fed(n, cohort_size=k,
                                                      **overrides),
                       TaskRequirement(), device="cpu",
                       draws=cohort_draws(jeng, rounds, overrides),
                       init_params=params)
    outs = eng.run(VirtualFleet(n, samples_per_client=samples, device="cpu"),
                   rounds=rounds)
    return jeng, jouts, eng, outs


# the store's columns compared exactly, and the fp32 ones within the band
EXACT_COLUMNS = ("score", "participations", "failures", "memory", "bandwidth",
                 "battery", "compute", "last_selected", "pending_weight",
                 "pending_issued", "pending_arrival", "pending_valid",
                 "round_idx")
CLOSE_COLUMNS = ("history", "residual", "pending_delta")


def assert_cohort_equal(jeng, jouts, eng, outs, *, level=None):
    """Per round, the cohort ``idx`` / ``valid``, trust and the selected /
    on-time masks exactly equal; at the end, every store column but the
    fp32 blocks exactly, the fp32 blocks and params within atol = rtol =
    2e-4.  With QSGD on, ``level`` is the run's largest quantization level
    and the residual and pending buffer are held by
    ``assert_close_up_to_flips``."""
    assert len(jouts) == len(outs)
    for r, ((jidx, jvalid, jo), (idx, valid, o)) in enumerate(zip(jouts, outs)):
        np.testing.assert_array_equal(idx, np.asarray(jidx), err_msg=f"round {r}")
        np.testing.assert_array_equal(valid, np.asarray(jvalid))
        for name in ("trust", "selected", "on_time", "round_time"):
            np.testing.assert_array_equal(getattr(o, name),
                                          np.asarray(getattr(jo, name)),
                                          err_msg=f"round {r} {name}")
    ours, theirs = eng.store.state_dict(), jeng.store.state_dict()
    for name in EXACT_COLUMNS:
        np.testing.assert_array_equal(ours[name], np.asarray(theirs[name]),
                                      err_msg=name)
    for name in CLOSE_COLUMNS:
        got, want = ours[name], np.asarray(theirs[name])
        if level is not None and name != "history":
            assert_close_up_to_flips(name, got, want, level=level,
                                     max_share=1e-4)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                       err_msg=name)
    np.testing.assert_allclose(eng.params.numpy(), np.asarray(jeng.params),
                               rtol=2e-4, atol=2e-4)
