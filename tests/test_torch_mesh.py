"""The port's client mesh on the CPU: the FedAR round sharded over k = 2 and
k = 4 gloo ranks (``repro_torch.core.distributed.spawn``) against the
port's one-process engine, as tests/test_mesh_engine.py holds the
reference's shard_map against its one-device engine.

N = 128 clients, ``small_model(32)``, 4 rounds; the cases are
``tests/_torch_mesh_jobs.CASES``: fedar, fedavg, async, async_seq, dense
FoolsGold (gathers (N, D)) and ``foolsgold_sketch`` (gathers (N, r)),
QSGD-8, async + QSGD-4 and top-k, the gated packed fleet, the padded fleet,
``robot_drift``, chaos faults and the cohort engine.  Each k runs every
case inside one spawned job.  The bars:

- selected, on-time, trust, the fault masks and the cohort store's integer
  columns identical;
- params within atol = rtol = 1e-4 (the reference's own mesh bar), and
  bit-identical on all ranks after every round;
- the defense history and the async buffer within 1e-4, except under
  QSGD, where a rank's params differ from the one-process run's in the
  last bits after round 1, and a code whose uniform lies that close to its
  rounding threshold flips: there they are held up to such flips (one
  level, ``scale / L``, on at most 1e-3 of the elements);
- the QSGD and top-k payloads of round 0 (the same inputs on every shard
  count) bit-identical across shard counts.

One more case runs the 4-rank mesh against the live JAX engine with the
reference's draws replayed: trust and selection identical, params within
2e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_jobs as jobs
from _torch_parity import reference_draws
from repro.configs.fedar_mnist import fleet_fed as jfleet_fed
from repro.configs.fedar_mnist import small_model as jsmall_model
from repro.core.engine import FedAREngine as JEngine
from repro.core.resources import TaskRequirement as JReq
from repro.data.federated import scaled_fleet as jscaled_fleet
from repro_torch.configs.fedar_mnist import fleet_fed, small_model
from repro_torch.core.distributed import ClientComms, client_mesh, spawn
from repro_torch.core.engine import FedAREngine
from repro_torch.core.fedar import FedARServer
from repro_torch.core.resources import TaskRequirement

SHARDS = (2, 4)
CASES = list(jobs.CASES)
COMPRESSED = ("qsgd8", "qsgd4_async", "topk")


def _jax_case():
    """The reference's 4-round run of fedar + foolsgold_sketch at N = 128,
    and what the port's ranks need to replay it: its init params and
    draws."""
    fed = jfleet_fed(jobs.N, local_epochs=1, defense="foolsgold_sketch")
    jeng = JEngine(jsmall_model(32), fed, JReq())
    data = {k: jnp.asarray(v)
            for k, v in jscaled_fleet(jobs.N, samples_per_client=40).items()}
    jstate, jouts = jeng.run(jeng.init_state(), data, rounds=jobs.ROUNDS)
    replay = reference_draws(0, jobs.ROUNDS, jobs.N)
    kw = dict(replay={k: v for k, v in replay.items() if v is not None},
              init_params={k: np.asarray(v) for k, v in jeng.template.items()})
    return (jstate, jouts), kw


@pytest.fixture(scope="module")
def runs():
    """The one-process engine on every case, then one spawned job per k
    (the k = 4 job also runs the live-JAX case)."""
    with jobs.one_thread():
        one = {name: jobs.run_case(name, 1) for name in CASES}
    ref, kw = _jax_case()
    meshed = {}
    for k in SHARDS:
        cases = CASES + ([("jax", "foolsgold_sketch", kw)] if k == 4 else [])
        meshed[k] = spawn(k, jobs.job, cases, device="cpu", timeout=300)
    return one, meshed, ref


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", SHARDS)
def test_mesh_matches_one_process(runs, k, case):
    one, meshed, _ = runs
    jobs.check_case(one[case], [r[case] for r in meshed[k]], case, k)


@pytest.mark.parametrize("case", COMPRESSED)
@pytest.mark.parametrize("k", SHARDS)
def test_mesh_codes_and_uplink_payload(runs, k, case):
    """Round 0's codes (QSGD's packed uint8 codes and scales, top-k's
    (value, index) pairs) are bit-identical across shard counts: QSGD's
    uniforms are keyed on the canonical client id.  Each rank records its
    own uplink in the packed wire format, N / k rows."""
    one, meshed, _ = runs
    want, ranks = one[case], meshed[k]
    for key, val in want["payload0"].items():
        np.testing.assert_array_equal(
            np.concatenate([r[case]["payload0"][key] for r in ranks]), val, err_msg=key)
    rows, dim = jobs.N // k, want["dim"]
    shapes = ranks[0][case]["uplink_shapes"]
    # one uplink a round, of one wire format: recorded once
    assert ranks[0][case]["uplink_rounds"] == jobs.ROUNDS and len(shapes) == 1
    for leaves in shapes:
        if case.startswith("qsgd"):
            bits = jobs.CASES[case]["compress_bits"]
            assert leaves == (((rows, -(-dim * bits // 8)), "uint8"),
                              ((rows, 1), "float32"))
        else:
            ck = jobs.CASES[case]["compress_k"]
            assert leaves == (((rows, ck), "int32"), ((rows, ck), "float32"))
    assert not ranks[0]["fedar"]["uplink_shapes"]  # uncompressed: none
    assert ranks[0]["fedar"]["uplink_rounds"] == 0


@pytest.mark.parametrize("case,width", [("foolsgold_sketch", "r"),
                                        ("foolsgold", "D")])
def test_mesh_defense_gathers_its_payload(runs, case, width):
    """The sketched defense gathers (N, r) across the ranks, the dense one
    the full (N, D) history."""
    _, meshed, _ = runs
    got = meshed[4][0][case]
    want = (jobs.N, 256 if width == "r" else got["dim"])
    assert got["defense_shapes"] and set(got["defense_shapes"]) == {want}


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_collectives(runs, k):
    """psum, the bool all-gather (uint8 on the wire), the tree reduce of a D
    not divisible by k and a width-0 gather."""
    ops = [r["_ops"] for r in runs[1][k]]
    xs = np.stack([o["x"] for o in ops])
    for o in ops:
        np.testing.assert_allclose(o["psum"], xs.sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(o["tree"], xs.sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(o["gathered"], np.concatenate([p["mask"] for p in ops]))
        assert o["gathered"].dtype == bool and o["empty"] == (3 * k, 0)
    for o in ops[1:]:
        np.testing.assert_array_equal(o["psum"], ops[0]["psum"])
        np.testing.assert_array_equal(o["tree"], ops[0]["tree"])


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_requires_divisible_fleet(runs, k):
    for rank in runs[1][k]:
        assert "divisible" in rank["_divisible"]


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_rejects_a_block_sized_fleet(runs, k):
    """A fleet of N / k clients handed to the N-client engine on a k-rank
    mesh raises rather than train the same block on every rank."""
    for rank in runs[1][k]:
        assert f"the fleet's {jobs.N}" in rank["_local_fleet"]


def test_mesh_without_process_group_raises():
    """``mesh_shape`` = k > 1 outside a process group of k ranks raises; the
    one-process engine has no mesh and identity comms."""
    with pytest.raises(RuntimeError, match="process group"):
        FedAREngine(small_model(8), fleet_fed(16, mesh_shape=4, defense="none"),
                    TaskRequirement(), device="cpu")
    assert client_mesh(fleet_fed(16, mesh_shape=1)) is None
    server = FedARServer(small_model(8), fleet_fed(16, defense="none"),
                         TaskRequirement(), device="cpu")
    assert server.mesh is None and type(server.engine.comms) is ClientComms
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            spawn(2, print, device="cuda")


def test_mesh_matches_live_jax_engine(runs):
    """The 4-rank mesh against the reference's one-device engine from its
    init params and draws: trust and selection identical, params within
    2e-4."""
    _, meshed, (jstate, jouts) = runs
    got = meshed[4][0]["jax"]
    np.testing.assert_array_equal(got["selected"], np.asarray(jouts.selected))
    np.testing.assert_array_equal(got["on_time"], np.asarray(jouts.on_time))
    np.testing.assert_array_equal(got["trust"], np.asarray(jouts.trust))
    np.testing.assert_allclose(got["params_rounds"][-1], np.asarray(jstate.params),
                               atol=2e-4, rtol=2e-4)
    hist = np.concatenate([r["jax"]["fg_history"] for r in meshed[4]])
    np.testing.assert_allclose(hist, np.asarray(jstate.fg_history), atol=2e-4, rtol=2e-4)

