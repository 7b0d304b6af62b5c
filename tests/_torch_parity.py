"""Shared harness of the port's parity tests: one config through the live
reference engine and through the port, on the same data, init params and
draws.

The reference's threefry draws (``fold_in(PRNGKey(seed), round)``, a 3-way
split for selection / latency, and for QSGD a ``0xC0DEC`` fold of the round
key then one fold per client id) are made here with JAX and replayed into
the port through ``convert.ReplayDraws``.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.fedar_mnist import fleet_fed as jfleet_fed
from repro.configs.fedar_mnist import small_model as jsmall_model
from repro.core.compress import client_keys
from repro.core.engine import FedAREngine as JEngine
from repro.core.resources import TaskRequirement as JReq
from repro.data.datasets import make_federated
from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.convert import ReplayDraws, params_from_jax
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import LATENCY_JITTER, TaskRequirement
from repro_torch.data.federated import table2_fleet

COMPRESS_KEY_FOLD = 0xC0DEC  # repro/core/engine.py's domain separator


def reference_draws(seed, rounds, n, dim=None):
    """``ReplayDraws`` keyword arguments: the (rounds, n) Gumbel draws and
    latency factors ``exp(LATENCY_JITTER * normal)``, plus the (rounds, n, dim)
    QSGD uniforms when ``dim`` is given.  The factor is one jitted
    computation, as inside the reference engine's jitted round: XLA folds
    the jitter into the normal's own scale there, which rounds otherwise
    than an eager ``normal`` followed by ``exp``."""
    factor = jax.jit(lambda k: jnp.exp(LATENCY_JITTER * jax.random.normal(k, (n,))))
    g, lat, u = [], [], []
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
    return dict(gumbel=np.stack(g), latency=np.stack(lat),
                uniform=np.stack(u) if dim is not None else None)


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
    draws = ReplayDraws(**reference_draws(0, rounds, 12,
                                          jeng.dim if needs_unif else None))
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
