"""The port's fleet serving from one aggregated checkpoint, on the CPU.

The invariants of ``tests/test_serve_fleet.py`` through
``repro_torch.serve`` with ``device="cpu"`` managers: layer groups equal
to the JAX package's on the same names, the leaf catalog, streamed
restores equal to full partial restores (codecs none, zstd, zstd+delta)
and pinned to one step, the decoded-chunk cache, the engine's
flush-done hooks, atomic hot swaps, concurrent cold starts over all
five strategies (from checkpoints saved by either package, serving the
reference's tokens), reader balance, ``swap_to``, the follower, and a
stub control plane for ``via_control_plane``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import get_model as ref_get_model
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import Server as RefServer
from repro.serve.stream import plan_layer_groups as ref_plan_layer_groups
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.transformer import Transformer
from repro_torch.serve import (
    ChunkCache,
    FleetConfig,
    ServeConfig,
    ServeFleet,
    Server,
    plan_layer_groups,
    stream_restore,
)
from repro_torch.utils.convert import tree_from_numpy
from repro_torch.utils.treelib import flatten_with_names, tree_map

ALL_STRATEGIES = ["file_per_process", "posix", "mpiio", "stripe_aligned", "gio_sync"]
KiB = 1024


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def blocky_state(step, n_blocks=4, kib=8):
    """A train state whose params look like a layered LM: embedding,
    numbered blocks, head, plus optimizer baggage serving must skip."""
    rng = np.random.default_rng(1000 + step)

    def arr(n):
        return torch.from_numpy(rng.standard_normal(n) + step)

    params = {"embed": arr(kib * KiB // 8)}
    for i in range(n_blocks):
        params[f"block_{i:03d}"] = {"w": arr(kib * KiB // 8), "b": arr(32)}
    params["head"] = arr(kib * KiB // 8)
    return {"params": params, "opt": {"mu": arr(kib * KiB // 8), "t": arr(4)}}


def leaves(tree):
    return [x for _, x in flatten_with_names(tree)[0]]


def trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def make_mgr(root, cluster=None, pkg=T, **kw):
    kw.setdefault("async_flush", False)
    if pkg is T:
        kw.setdefault("device", "cpu")
    return pkg.CheckpointManager(
        pkg.CheckpointConfig(root=str(root), cluster=cluster or pkg.theta_like(2, 2), **kw))


def forget_memory(mgr):
    mgr._l0 = None
    mgr._last_full = None


def smoke_model():
    cfg = get_smoke_config("tinyllama-1.1b")
    return get_model(cfg)


def smoke_params(model, seed):
    return model.init(torch.Generator().manual_seed(seed), "cpu").state_tree()


def meta_template(model):
    return Transformer(model.cfg, device="meta").state_tree()


def prompts(b, s, value):
    return {"tokens": np.full((b, s), value, np.int32)}


def reference_tokens(model, params, batch, n):
    return Server(model, params, ServeConfig(max_new_tokens=n)).generate(batch)[0]


def train_save(root, step, params, pkg=T, strategy="stripe_aligned", **kw):
    """A train state of ``params`` saved under the training geometry."""
    mu = torch.zeros(4096) if pkg is T else jnp.zeros((4096,), jnp.float32)
    mgr = make_mgr(root, cluster=pkg.theta_like(4, 2), pkg=pkg, strategy=strategy, **kw)
    mgr.save(step, {"params": params, "opt": {"mu": mu}})
    mgr.close()


def fleet_checkpoint(tmp_path, strategy="stripe_aligned", **kw):
    """A real model train state saved at step 3; returns (model, params,
    serving manager on another geometry over the same root)."""
    model = smoke_model()
    params = smoke_params(model, 0)
    train_save(tmp_path, 3, params, strategy=strategy, **kw)
    return model, params, make_mgr(tmp_path, cluster=T.theta_like(2, 1), strategy=strategy, **kw)


# ---------------------------------------------------------------------------
# layer grouping + leaf catalog
# ---------------------------------------------------------------------------


def _model_names(arch, prefix):
    model = get_model(get_smoke_config(arch))
    return [(prefix + n, x.numel() * 4) for n, x in
            flatten_with_names(meta_template(model))[0]]


GROUP_CASES = {
    "explicit": ([("['params']['head']", 10), ("['params']['block_001']['w']", 30),
                  ("['params']['embed']", 20), ("['params']['block_000']['b']", 5),
                  ("['params']['block_000']['w']", 25)], 1),
    "blocky": ([("['params']" + n, x.numel() * 8)
                for n, x in flatten_with_names(blocky_state(1, n_blocks=6)["params"])[0]], 2),
    "stacked_tinyllama": (_model_names("tinyllama-1.1b", ""), 1),
    "stacked_qwen_train_state": (_model_names("qwen1.5-0.5b", "['train']['params']"), 1),
    "numbered_variants": ([("['layers_3']['w']", 4), ("['h5']", 4), ("['blocks.2']['w']", 4),
                           ("['wte']", 4), ("['ln_f']", 4), ("['misc']", 4)], 2),
    "degenerate": ([("['a']", 3), ("['b']", 4)], 1),
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_layer_groups_equal_the_reference(case):
    entries, prio = GROUP_CASES[case]
    got = plan_layer_groups(entries, priority_blocks=prio)
    want = ref_plan_layer_groups(entries, priority_blocks=prio)
    assert [(g.name, g.leaves, g.nbytes, g.priority) for g in got] == \
        [(g.name, g.leaves, g.nbytes, g.priority) for g in want]
    seen = [n for g in got for n in g.leaves]
    assert sorted(seen) == sorted(n for n, _ in entries) and len(seen) == len(set(seen))


def test_plan_layer_groups_order_and_priority():
    groups = plan_layer_groups(GROUP_CASES["explicit"][0], priority_blocks=1)
    assert [g.name for g in groups] == ["embed", "block_00000", "block_00001", "tail"]
    assert set(groups[1].leaves) == {"['params']['block_000']['w']",
                                     "['params']['block_000']['b']"}
    assert groups[1].nbytes == 30
    assert [g.priority for g in groups] == [True, True, False, False]
    # stacked layers (every layer in one leaf): embed, one middle group, tail;
    # the priority prefix is the embedding alone
    stacked = plan_layer_groups(GROUP_CASES["stacked_qwen_train_state"][0])
    assert [(g.name, g.priority) for g in stacked] == [
        ("embed", True), ("mid", False), ("tail", False)]


def test_leaf_catalog_newest_step_and_prefix(tmp_path):
    mgr = make_mgr(tmp_path)
    mgr.save(1, blocky_state(1))
    mgr.save(2, blocky_state(2))
    step, entries = mgr.leaf_catalog(prefix="['params']")
    assert step == 2 and all(e.name.startswith("['params']") for e in entries)
    assert sum(e.size for e in entries) == sum(
        x.numel() * x.element_size() for x in leaves(blocky_state(2)["params"]))
    step1, e1 = mgr.leaf_catalog(step=1, prefix="['opt']")
    assert step1 == 1 and all(e.name.startswith("['opt']") for e in e1)
    with pytest.raises(FileNotFoundError):
        mgr.leaf_catalog(prefix="['nope']")
    mgr.close()
    with pytest.raises(FileNotFoundError):
        make_mgr(tmp_path / "empty").leaf_catalog()


# ---------------------------------------------------------------------------
# streamed (lazy) restore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["none", "zstd", "zstd+delta"])
def test_stream_restore_matches_full_restore(tmp_path, codec):
    mgr = make_mgr(tmp_path, codec=codec, delta_every=2)
    for s in (1, 2, 3):  # a delta chain under zstd+delta
        mgr.save(s, blocky_state(s))
    forget_memory(mgr)
    template = blocky_state(3)["params"]
    sr = stream_restore(mgr, template)
    ref_step, ref = mgr.restore_subtree(template, "['params']")
    assert sr.step == ref_step == 3
    assert trees_equal(sr.params, ref) and trees_equal(sr.params, template)
    assert 0 < sr.ttft_s <= sr.total_s
    mgr.close()


def test_stream_restore_priority_prefix_and_byte_accounting(tmp_path):
    mgr = make_mgr(tmp_path)
    mgr.save(5, blocky_state(5, n_blocks=8))
    forget_memory(mgr)
    template = tree_map(lambda x: x.to("meta"), blocky_state(5, n_blocks=8)["params"])
    sr = stream_restore(mgr, template, priority_blocks=1)
    assert 0 < sr.priority_bytes < sr.total_bytes
    assert sr.total_bytes == sum(x.numel() * 8 for x in leaves(template))
    order = [g.name for g in sr.groups]
    assert order[0] == "embed" and order[-1] == "tail"
    done = [sr.group_done_s[n] for n in order]
    assert done == sorted(done)
    prefix_end = max(sr.group_done_s[g.name] for g in sr.groups if g.priority)
    assert abs(sr.ttft_s - prefix_end) < 1e-9
    assert trees_equal(sr.params, blocky_state(5, n_blocks=8)["params"])
    mgr.close()


def test_stream_restore_pins_step_against_newer_arrivals(tmp_path):
    """A newer step landing mid-stream must NOT mix into the result:
    every group is pinned to the step chosen at stream start."""
    mgr = make_mgr(tmp_path)
    mgr.save(1, blocky_state(1))
    forget_memory(mgr)
    real = mgr.restore_leaves
    fired = []

    def racing_restore_leaves(names, step=None):
        if not fired:
            fired.append(True)
            mgr.save(2, blocky_state(2))  # newer step lands mid-stream
            forget_memory(mgr)
        return real(names, step=step)

    mgr.restore_leaves = racing_restore_leaves
    sr = stream_restore(mgr, blocky_state(1)["params"])
    assert sr.step == 1 and fired
    assert trees_equal(sr.params, blocky_state(1)["params"])
    mgr.close()


def test_stream_restore_places_groups(tmp_path):
    """Without a ``sharding_fn`` every group goes to ``manager.device``
    (here a manager whose device is the meta device, so the move is
    visible on the CPU); with one, every leaf goes through it."""
    mgr = make_mgr(tmp_path)
    mgr.save(1, blocky_state(1))
    forget_memory(mgr)
    template = blocky_state(1)["params"]
    seen = []

    def shard(name, leaf):
        seen.append(name)
        return leaf.double() * 2

    sr = stream_restore(mgr, template, sharding_fn=shard)
    assert len(seen) == len(leaves(template))
    assert trees_equal(sr.params, tree_map(lambda x: x * 2, template))
    mgr.device = torch.device("meta")
    sr = stream_restore(mgr, template)
    assert all(x.device.type == "meta" for x in leaves(sr.params))
    mgr.close()


# ---------------------------------------------------------------------------
# decoded-chunk cache
# ---------------------------------------------------------------------------


def test_chunk_cache_unit_hits_misses_lru():
    c = ChunkCache(capacity_bytes=300)
    assert c.get(("s", 0)) is None           # miss
    a = np.arange(100, dtype=np.uint8)
    c.put(("s", 0), a)
    hit = c.get(("s", 0))
    assert hit is not None and np.array_equal(hit, a)
    assert not hit.flags.writeable            # frozen: shared across servers
    c.put(("s", 1), np.zeros(100, np.uint8))
    c.put(("s", 2), bytearray(100))           # any buffer
    c.get(("s", 0))                           # refresh 0's recency
    c.put(("s", 3), np.zeros(100, np.uint8))  # evicts LRU (key 1)
    assert c.get(("s", 1)) is None
    assert c.get(("s", 0)) is not None
    c.put(("s", 4), np.zeros(301, np.uint8))  # larger than the cache: dropped
    st = c.stats()
    assert st["hits"] >= 3 and st["misses"] >= 2 and st["evictions"] >= 1
    assert st["size_bytes"] <= 300 and st["bytes_saved"] == 300


def test_chunk_cache_dedups_second_restore(tmp_path):
    mgr = make_mgr(tmp_path, codec="zstd", chunk_size=4 * KiB)
    mgr.save(1, blocky_state(1, kib=32))
    forget_memory(mgr)
    mgr.chunk_cache = ChunkCache()
    template = blocky_state(1, kib=32)["params"]
    a = stream_restore(mgr, template)
    misses = mgr.chunk_cache.stats()["misses"]
    assert misses > 0
    b = stream_restore(mgr, template)
    st = mgr.chunk_cache.stats()
    assert st["hits"] > 0 and st["misses"] == misses and st["bytes_saved"] > 0
    assert trees_equal(a.params, b.params) and trees_equal(a.params, template)
    mgr.close()


def test_chunk_cache_dedups_delta_base_reads(tmp_path):
    """Two delta steps share a full-snapshot base: after restoring the
    first, the second's base-referencing chunks hit the cache."""
    mgr = make_mgr(tmp_path, codec="zstd+delta", delta_every=4, chunk_size=4 * KiB)
    s1 = blocky_state(1, kib=32)
    mgr.save(1, s1)
    s2 = tree_map(torch.clone, s1)
    s2["params"]["embed"] += 1.0
    mgr.save(2, s2)
    s3 = tree_map(torch.clone, s2)
    s3["params"]["head"] += 1.0
    mgr.save(3, s3)
    forget_memory(mgr)
    mgr.chunk_cache = ChunkCache()
    a = stream_restore(mgr, s1["params"], step=2)
    hits = mgr.chunk_cache.stats()["hits"]
    b = stream_restore(mgr, s1["params"], step=3)
    assert mgr.chunk_cache.stats()["hits"] > hits
    assert trees_equal(a.params, s2["params"]) and trees_equal(b.params, s3["params"])
    mgr.close()


def test_chunk_cache_capacity_zero_disables_without_breaking(tmp_path):
    mgr = make_mgr(tmp_path, codec="zstd", chunk_size=4 * KiB)
    mgr.save(1, blocky_state(1))
    forget_memory(mgr)
    mgr.chunk_cache = ChunkCache(capacity_bytes=0)
    sr = stream_restore(mgr, blocky_state(1)["params"])
    assert trees_equal(sr.params, blocky_state(1)["params"])
    assert mgr.chunk_cache.stats()["size_bytes"] == 0
    mgr.close()


# ---------------------------------------------------------------------------
# engine hooks: subscribe / step_status
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("async_flush", [False, True])
def test_subscribe_fires_on_flush_done(tmp_path, async_flush):
    got = []
    mgr = make_mgr(tmp_path, async_flush=async_flush)
    mgr.subscribe(got.append)
    mgr.save(7, blocky_state(7))
    mgr.wait()
    assert got == [7]
    mgr.close()


def test_unsubscribe_and_callback_errors_are_isolated(tmp_path):
    def boom(step):
        raise RuntimeError("subscriber bug")

    got = []
    mgr = make_mgr(tmp_path)
    mgr.subscribe(boom)
    mgr.subscribe(got.append)
    mgr.save(1, blocky_state(1))      # boom must not break the flush
    assert got == [1] and mgr.flush_errors == [] and 1 in mgr.steps("pfs")
    mgr.unsubscribe(got.append)
    mgr.save(2, blocky_state(2))
    assert got == [1]
    assert mgr.step_status(2) == "flush_done"
    assert mgr.step_status(2, level="local") == "local_done"
    assert mgr.step_status(9) is None
    mgr.close()


# ---------------------------------------------------------------------------
# Server hot-swap primitives
# ---------------------------------------------------------------------------


def test_swap_params_bumps_version_and_generate_reports_it():
    model = smoke_model()
    p0, p1 = smoke_params(model, 0), smoke_params(model, 1)
    server = Server(model, p0, ServeConfig(max_new_tokens=4))
    assert server.params_version == 0
    batch = prompts(2, 5, 7)
    assert server.generate(batch, with_version=True)[2] == 0
    assert server.swap_params(p1) == 1 and server.params_version == 1
    toks1, _, v1 = server.generate(batch, with_version=True)
    assert v1 == 1
    np.testing.assert_array_equal(toks1, reference_tokens(model, p1, batch, 4))
    assert server.params is p1
    snap = server.snapshot_state(cache={"k": torch.zeros(1)})
    assert snap["params"] is p1


def test_generate_uses_exactly_one_version_under_concurrent_swaps():
    """Linearizability: each generate's output equals the reference of
    exactly the version it reports, never a torn mix."""
    model = smoke_model()
    p0, p1 = smoke_params(model, 0), smoke_params(model, 1)
    server = Server(model, p0, ServeConfig(max_new_tokens=3))
    batch = prompts(2, 4, 5)
    refs = {0: reference_tokens(model, p0, batch, 3), 1: reference_tokens(model, p1, batch, 3)}
    assert not np.array_equal(refs[0], refs[1])  # distinguishable versions
    results, errors = [], []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                toks, _, v = server.generate(batch, with_version=True)
                results.append((v, toks))
            except Exception as e:  # pragma: no cover - failure reporting
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for th in threads:
        th.start()
    for p in [p1, p0, p1, p0, p1]:
        time.sleep(0.05)
        server.swap_params(p)
    stop.set()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors and results
    for v, toks in results:
        np.testing.assert_array_equal(toks, refs[v % 2])


# ---------------------------------------------------------------------------
# ServeFleet: concurrent cold start
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("saver", ["torch", "jax"])
@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_fleet_cold_start_concurrent_byte_identity(tmp_path, strategy, saver):
    """Three replicas boot concurrently from one step saved by either
    package, each byte-identical to the saved params, from a template on
    the meta device; a JAX-saved step serves the JAX server's tokens."""
    model = smoke_model()
    if saver == "torch":
        params = smoke_params(model, 0)
        train_save(tmp_path, 3, params, strategy=strategy)
    else:
        ref_model = ref_get_model(ref_smoke_config("tinyllama-1.1b"))
        ref_p = ref_model.init(jax.random.PRNGKey(0))
        train_save(tmp_path, 3, ref_p, pkg=R, strategy=strategy)
        params = tree_from_numpy(jax.tree_util.tree_map(np.asarray, ref_p), "cpu")
    mgr = make_mgr(tmp_path, cluster=T.theta_like(2, 1), strategy=strategy)
    fleet = ServeFleet(model, mgr, meta_template(model),
                       cfg=FleetConfig(n_servers=3, serve=ServeConfig(max_new_tokens=3)))
    cs = fleet.cold_start()
    assert cs.step == 3 and fleet.current_step == 3 and len(fleet.servers) == 3
    for srv in fleet.servers:
        assert trees_equal(srv.params, params)
    assert len(cs.ttft_s) == 3 and all(x > 0 for x in cs.ttft_s)
    assert cs.total_bytes == sum(x.numel() * 4 for x in leaves(params))
    if saver == "jax":
        batch = prompts(2, 5, 7)
        want, _ = RefServer(ref_model, ref_p, RefServeConfig(max_new_tokens=3)).generate(
            {"tokens": jnp.asarray(batch["tokens"])})
        np.testing.assert_array_equal(fleet.servers[0].generate(batch)[0], np.asarray(want))
    fleet.close()
    mgr.close()


def test_fleet_cold_start_shares_cache_across_servers(tmp_path):
    model, params, mgr = fleet_checkpoint(tmp_path, codec="zstd", chunk_size=4 * KiB)
    fleet = ServeFleet(model, mgr, meta_template(model), cfg=FleetConfig(n_servers=3))
    st = fleet.cold_start().cache
    assert st is not None and st["hits"] > 0 and st["bytes_saved"] > 0
    assert mgr.chunk_cache is fleet.cache            # node-local, shared
    # a second fleet on the node adopts the installed cache
    other = ServeFleet(model, mgr, meta_template(model), cfg=FleetConfig(n_servers=1))
    assert other.cache is fleet.cache
    fleet.close()
    mgr.close()


def test_fleet_reader_balance_uses_serving_geometry(tmp_path):
    model, params, mgr = fleet_checkpoint(tmp_path)
    fleet = ServeFleet(model, mgr, meta_template(model), cfg=FleetConfig(n_servers=1))
    bal = fleet.reader_balance()
    assert bal["step"] == 3 and bal["n_readers"] == mgr.cluster.n_nodes
    assert bal["max_bytes"] >= bal["min_bytes"] >= 0
    sizes = [r.stored_size for r in mgr._manifest_pfs(3).ranks]
    assert bal["max_bytes"] <= sum(sizes) / bal["n_readers"] + max(sizes)
    np.testing.assert_array_equal(bal["readers"], T.assign_readers(sizes, mgr.cluster.n_nodes))
    assert int(bal["bytes_per_reader"].sum()) == sum(sizes)
    fleet.close()
    mgr.close()


def test_fleet_cold_start_generates_after_lazy_load(tmp_path):
    model, params, mgr = fleet_checkpoint(tmp_path)
    fleet = ServeFleet(model, mgr, meta_template(model),
                       cfg=FleetConfig(n_servers=2, serve=ServeConfig(max_new_tokens=4)))
    fleet.cold_start()
    batch = prompts(2, 5, 7)
    ref = reference_tokens(model, params, batch, 4)
    for srv in fleet.servers:
        np.testing.assert_array_equal(srv.generate(batch)[0], ref)
    fleet.close()
    mgr.close()


# ---------------------------------------------------------------------------
# ServeFleet: snapshot hot-swap
# ---------------------------------------------------------------------------


def test_swap_to_rolls_every_server(tmp_path):
    model, params, mgr = fleet_checkpoint(tmp_path)
    fleet = ServeFleet(model, mgr, meta_template(model),
                       cfg=FleetConfig(n_servers=2, serve=ServeConfig(max_new_tokens=3)))
    fleet.cold_start()
    assert fleet.swap_to() == 3 and all(s.params_version == 0 for s in fleet.servers)
    p2 = smoke_params(model, 2)
    train_save(tmp_path, 5, p2)          # a newer step from "training"
    assert fleet.swap_to() == 5 and fleet.current_step == 5
    batch = prompts(1, 4, 3)
    ref = reference_tokens(model, p2, batch, 3)
    for srv in fleet.servers:
        toks, _, v = srv.generate(batch, with_version=True)
        np.testing.assert_array_equal(toks, ref)
        assert v == 1                    # exactly one roll happened
    assert fleet.swap_history and fleet.swap_history[-1][0] == 5
    fleet.close()
    mgr.close()


def test_follower_adopts_only_flush_done(tmp_path):
    """Manifests at flush_partial / superseded / quarantined newer than
    the served step must never be adopted; a real flush_done step is."""
    model, params, mgr = fleet_checkpoint(tmp_path)
    fleet = ServeFleet(model, mgr, meta_template(model),
                       cfg=FleetConfig(n_servers=1, poll_interval=0.02))
    fleet.cold_start()
    src = mgr.pfs_dir / "step_00000003" / "manifest.json"
    for step, status in ((7, "flush_partial"), (8, "superseded"), (9, "quarantined")):
        man = T.Manifest.from_json(src.read_text())
        man.step, man.status = step, status
        d = mgr.pfs_dir / f"step_{step:08d}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "manifest.json").write_text(man.to_json())
    fleet.start_follower()
    time.sleep(0.3)
    assert fleet.current_step == 3          # nothing non-final adopted
    p2 = smoke_params(model, 2)
    train_save(tmp_path, 11, p2)
    deadline = time.monotonic() + 30
    while fleet.current_step != 11 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert fleet.current_step == 11
    assert trees_equal(fleet.servers[0].params, p2)
    fleet.stop()
    fleet.close()
    mgr.close()


def test_follower_hot_swap_drops_no_generates(tmp_path):
    """Generates hammering the fleet while the follower rolls params:
    every generate completes and matches exactly one version's
    reference output (no torn swap, nothing dropped), and no thread
    sees the version go backwards."""
    model, params, mgr = fleet_checkpoint(tmp_path)
    fleet = ServeFleet(model, mgr, meta_template(model),
                       cfg=FleetConfig(n_servers=1, poll_interval=0.02,
                                       serve=ServeConfig(max_new_tokens=3)))
    fleet.cold_start()
    batch = prompts(2, 4, 5)
    p2 = smoke_params(model, 2)
    refs = {0: reference_tokens(model, params, batch, 3), 1: reference_tokens(model, p2, batch, 3)}
    results, errors = {0: [], 1: []}, []
    stop = threading.Event()

    def hammer(i):
        srv = fleet.servers[0]
        while not stop.is_set():
            try:
                toks, _, v = srv.generate(batch, with_version=True)
                results[i].append((v, toks))
            except Exception as e:  # pragma: no cover - failure reporting
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    fleet.start_follower()
    train_save(tmp_path, 6, p2)
    deadline = time.monotonic() + 30
    while fleet.current_step != 6 and time.monotonic() < deadline:
        time.sleep(0.02)
    while not any(v == 1 for r in results.values() for v, _ in list(r)) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    stop.set()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    fleet.stop()
    assert not errors and fleet.current_step == 6
    assert 1 in {v for r in results.values() for v, _ in r}
    for r in results.values():
        versions = [v for v, _ in r]
        assert versions == sorted(versions)
        for v, toks in r:
            np.testing.assert_array_equal(toks, refs[min(v, 1)])
    fleet.close()
    mgr.close()


@pytest.mark.parametrize("error", [OSError, RuntimeError])
def test_follower_retries_storage_errors_only(tmp_path, error):
    """A storage fault in a swap is retried next round; any other error
    (a device error in the upload) ends the follower instead of being
    swallowed, and the servers keep the version they serve."""
    model, params, mgr = fleet_checkpoint(tmp_path)
    fleet = ServeFleet(model, mgr, meta_template(model),
                       cfg=FleetConfig(n_servers=1, poll_interval=0.02))
    fleet.cold_start()
    real, calls = fleet.swap_to, []

    def failing_once(step=None):
        calls.append(step)
        if len(calls) == 1:
            raise error("injected swap failure")
        return real(step)

    fleet.swap_to = failing_once
    train_save(tmp_path, 4, smoke_params(model, 2))
    fleet.start_follower()
    deadline = time.monotonic() + 30
    while fleet.current_step != 4 and fleet._follower.is_alive() \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    if error is OSError:
        assert fleet.current_step == 4 and len(calls) == 2
    else:
        fleet._follower.join(timeout=30)
        assert not fleet._follower.is_alive() and len(calls) == 1
        assert fleet.current_step == 3 and fleet.servers[0].params_version == 0
    fleet.close()
    mgr.close()


def test_fleet_stop_and_close_idempotent(tmp_path):
    model, params, mgr = fleet_checkpoint(tmp_path)
    fleet = ServeFleet(model, mgr, meta_template(model), cfg=FleetConfig(n_servers=1))
    fleet.cold_start()
    fleet.start_follower()
    fleet.start_follower()                # a second start is a no-op
    fleet.stop()
    fleet.stop()                          # second stop is a no-op
    assert mgr._subscribers == []         # the flush-done hook is released
    fleet.close()
    fleet.close()
    assert fleet.servers == []
    mgr.close()


class StubPlane:
    """The surface of a control plane a fleet uses: a manager registry
    and per-tenant flush-done subscriptions."""

    def __init__(self, managers):
        self.managers = managers
        self.subs = {}

    def manager(self, job):
        return self.managers[job]

    def subscribe(self, job, fn):
        self.subs.setdefault(job, []).append(fn)

    def unsubscribe(self, job, fn):
        self.subs[job].remove(fn)


def test_fleet_via_control_plane_stub(tmp_path):
    model, params, mgr = fleet_checkpoint(tmp_path)
    plane = StubPlane({"tenant-a": mgr})
    fleet = ServeFleet.via_control_plane(
        model, plane, "tenant-a", meta_template(model),
        cfg=FleetConfig(n_servers=2, poll_interval=5.0))
    assert fleet.manager is mgr
    assert fleet.cold_start().step == 3
    fleet.start_follower()
    assert len(plane.subs["tenant-a"]) == 1   # subscribed through the plane
    p2 = smoke_params(model, 2)
    train_save(tmp_path, 4, p2)
    for fn in list(plane.subs["tenant-a"]):   # the plane's flush-done event
        fn(4)
    deadline = time.monotonic() + 30          # long poll: the wakeup swaps
    while fleet.current_step != 4 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert fleet.current_step == 4 and trees_equal(fleet.servers[1].params, p2)
    fleet.close()
    assert plane.subs["tenant-a"] == []       # released through the plane
    mgr.close()
