"""The port's serving path held against the JAX reference on the CPU.

The same NumPy parameters, prompts and caches go through
``repro.models``/``repro.serve`` (un-jitted where the reference allows)
and ``repro_torch.models``/``repro_torch.serve`` with ``device="cpu"``:
the decode-side attention, prefill and teacher-forced decode steps,
greedy tokens through ``Server.generate``, a server booted from a
partial restore, and serving snapshots (params + ``DecodeCache`` +
next token) saved by either package and continued by the other. Each
test states its tolerance: float32 cases are held to rounding, the
bf16-compute case to bf16 resolution, tokens to equality.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import attention as ref_attention
from repro.models import get_model as ref_get_model
from repro.models import transformer as ref_transformer
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import Server as RefServer
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, get_model, transformer
from repro_torch.serve import ServeConfig, Server
from repro_torch.utils.convert import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.utils.treelib import flatten_with_names

DENSE = ["qwen1.5-0.5b", "tinyllama-1.1b"]
ATOL = 1e-5   # float32 compute: the packages sum in different orders


def ref_params(arch, seed=0, **replace):
    cfg = ref_smoke_config(arch).replace(**replace)
    model = ref_get_model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def port_model(arch, params_np, **replace):
    model = get_model(get_smoke_config(arch).replace(**replace))
    return model, params_from_numpy(params_np, model, "cpu").state_tree()


def tokens(seed, b, s, v=256):
    return np.random.default_rng(seed).integers(0, v, (b, s)).astype(np.int32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


# -- KV cache and decode attention -------------------------------------------


@pytest.mark.parametrize("window", [None, 3])
def test_kv_cache_and_decode_attention_match_reference(window):
    r = np.random.default_rng(1)
    b, s_max, h_q, h_kv, hd = 2, 12, 8, 2, 16
    k0, v0 = (r.standard_normal((b, s_max, h_kv, hd)).astype(np.float32) for _ in range(2))
    pos = np.array(5, np.int32)
    k_new, v_new = (r.standard_normal((b, 2, h_kv, hd)).astype(np.float32) for _ in range(2))
    q = r.standard_normal((b, 2, h_q, hd)).astype(np.float32)

    ref = ref_attention.cache_update(
        ref_attention.KVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(pos)),
        jnp.asarray(k_new), jnp.asarray(v_new))
    given = attention.KVCache(t(k0), t(v0), t(pos))
    got = attention.cache_update(given, t(k_new), t(v_new))
    assert isinstance(got, attention.KVCache) and got.pos.dtype == torch.int32
    for a, w in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    # the cache it was given is unchanged
    assert np.array_equal(given.k.numpy(), k0) and np.array_equal(given.v.numpy(), v0)
    assert int(given.pos) == 5

    want = ref_attention.decode_attention(jnp.asarray(q), ref, window=window)
    close(attention.decode_attention(t(q), got, window=window).numpy(), want)
    zero = attention.KVCache.zeros(b, s_max, h_kv, hd, torch.float32)
    ref_zero = ref_attention.KVCache.zeros(b, s_max, h_kv, hd, jnp.float32)
    assert all(np.array_equal(a.numpy(), np.asarray(w)) for a, w in zip(zero, ref_zero))


# -- prefill and decode ------------------------------------------------------


def _run_both(arch, *, seed, b, s, steps, s_max, **replace):
    """Prefill then ``steps`` decode steps teacher-forced on fixed
    tokens, through both packages; yields (what, got, want)."""
    ref_model, ref_p, ref_np = ref_params(arch, seed=seed, **replace)
    model, params = port_model(arch, ref_np, **replace)
    prompt = tokens(seed, b, s)
    forced = tokens(seed + 100, b, steps)
    r_cache, r_logits = ref_model.prefill(ref_p, {"tokens": jnp.asarray(prompt)}, s_max=s_max)
    with torch.inference_mode():
        cache, logits = model.prefill(params, {"tokens": t(prompt)}, s_max=s_max)
        yield "prefill logits", logits, r_logits
        yield "prefill cache", cache, r_cache
        for i in range(steps):
            tok = forced[:, i : i + 1]
            r_logits, r_cache = ref_model.decode_step(ref_p, r_cache, jnp.asarray(tok))
            logits, cache = model.decode_step(params, cache, t(tok))
            yield f"step {i} logits", logits, r_logits
        yield "final cache", cache, r_cache


# (prompt length, chunk_q): the unchunked and the query-chunked prefill
PREFILL_PATHS = {"unchunked": (9, 1024), "chunked": (16, 8)}


@pytest.mark.parametrize("path", list(PREFILL_PATHS))
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch, path):
    s, chunk_q = PREFILL_PATHS[path]
    for what, got, want in _run_both(arch, seed=3, b=2, s=s, steps=4, s_max=s + 6,
                                     chunk_q=chunk_q):
        if "cache" in what:
            assert isinstance(got, transformer.DecodeCache), what
            assert got.k.shape == want.k.shape and got.k.dtype == torch.float32, what
            close(got.k.numpy(), want.k, ATOL)
            close(got.v.numpy(), want.v, ATOL)
            assert int(got.pos) == int(want.pos) and got.pos.dtype == torch.int32, what
        else:
            assert got.shape == want.shape, what
            close(got.numpy(), want, ATOL)


def test_prefill_and_decode_bf16_compute_match_reference():
    """qwen1.5-0.5b's published numerics (bf16 compute) at smoke widths,
    at the tolerance of ``test_bf16_compute_matches_reference``: logits
    within 4 bf16 ulps of their largest value; the cache (bf16, as the
    reference stores it) within 4 ulps of its largest value."""
    for what, got, want in _run_both("qwen1.5-0.5b", seed=4, b=2, s=12, steps=3, s_max=16,
                                     compute_dtype="bfloat16"):
        if "cache" in what:
            assert got.k.dtype == torch.bfloat16, what
            for a, w in ((got.k, want.k), (got.v, want.v)):
                w = np.asarray(w.astype(jnp.float32))
                close(a.float().numpy(), w, 4 * 2.0 ** -8 * np.abs(w).max())
        else:
            assert got.dtype == torch.bfloat16, what
            w = np.asarray(want.astype(jnp.float32))
            close(got.float().numpy(), w, 4 * 2.0 ** -8 * np.abs(w).max())


def test_decode_step_leaves_its_cache_unchanged():
    _, _, ref_np = ref_params("tinyllama-1.1b", seed=5)
    model, params = port_model("tinyllama-1.1b", ref_np)
    with torch.inference_mode():
        cache, _ = model.prefill(params, {"tokens": t(tokens(5, 2, 6))}, s_max=10)
        kept = [x.clone() for x in cache]
        _, new = model.decode_step(params, cache, t(tokens(6, 2, 1)))
    assert all(torch.equal(a, b) for a, b in zip(cache, kept))
    assert int(new.pos) == 7 and not torch.equal(new.k, cache.k)


def test_cache_struct_and_init_cache():
    cfg = get_smoke_config("tinyllama-1.1b")
    model = get_model(cfg)
    struct = model.cache_struct(3, 20)
    want = ref_get_model(ref_smoke_config("tinyllama-1.1b")).cache_struct(3, 20)
    assert isinstance(struct, transformer.DecodeCache)
    for a, w in zip(struct, want):
        assert a.device.type == "meta" and tuple(a.shape) == w.shape
        assert str(a.dtype) == "torch." + str(w.dtype)
    params = model.init(torch.Generator().manual_seed(0), "cpu").state_tree()
    cache = model.init_cache(params, 3, 20)
    assert cache.k.device.type == "cpu" and not cache.k.any() and int(cache.pos) == 0


# -- the server --------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"])
def test_greedy_tokens_match_the_reference_server(arch):
    ref_model, ref_p, ref_np = ref_params(arch, seed=7)
    model, params = port_model(arch, ref_np)
    prompt = tokens(7, 3, 7)
    want, _ = RefServer(ref_model, ref_p, RefServeConfig(max_new_tokens=6)).generate(
        {"tokens": jnp.asarray(prompt)})
    server = Server(model, params, ServeConfig(max_new_tokens=6))
    got, cache = server.generate({"tokens": prompt})
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert int(cache.pos) == 7 + 6 and cache.k.shape[2] == 13
    # a tensor prompt gives the same tokens; no autograd graph is built
    again, cache2 = server.generate({"tokens": t(prompt)})
    np.testing.assert_array_equal(again, got)
    assert not cache2.k.requires_grad
    assert any(p.requires_grad for _, p in flatten_with_names(params)[0])


def test_generate_refuses_params_spread_over_devices():
    _, _, ref_np = ref_params("tinyllama-1.1b")
    model, params = port_model("tinyllama-1.1b", ref_np)
    params = dict(params, final_norm=params["final_norm"].to("meta"))
    with pytest.raises(ValueError, match="one device"):
        Server(model, params).generate({"tokens": tokens(0, 1, 4)})


def test_server_boots_from_partial_restore(tmp_path):
    """Serving pulls ONLY the params subtree out of a full train-state
    checkpoint (aggregated partial read), on a different geometry, from
    a template on the meta device."""
    ref_model, ref_p, ref_np = ref_params("tinyllama-1.1b")
    model, params = port_model("tinyllama-1.1b", ref_np)
    state = {"params": params, "opt": {"mu": torch.zeros(4096)}}
    mgr = T.CheckpointManager(T.CheckpointConfig(
        root=str(tmp_path), cluster=T.theta_like(4, 2), strategy="stripe_aligned",
        async_flush=False, device="cpu"))
    mgr.save(3, state)
    mgr.close()

    mgr2 = T.CheckpointManager(T.CheckpointConfig(
        root=str(tmp_path), cluster=T.theta_like(2, 1), strategy="posix", device="cpu"))
    template = transformer.Transformer(model.cfg, device="meta").state_tree()
    server, step = Server.from_checkpoint(model, mgr2, template,
                                          cfg=ServeConfig(max_new_tokens=4))
    assert step == 3
    total = sum(r.stored_size for r in mgr2._manifest_pfs(3).ranks)
    assert mgr2.last_read_result.bytes_read < total
    prompts = {"tokens": np.full((2, 5), 7, np.int32)}
    toks, cache = server.generate(prompts)
    ref, _ = RefServer(ref_model, ref_p, RefServeConfig(max_new_tokens=4)).generate(
        {"tokens": jnp.asarray(prompts["tokens"])})
    np.testing.assert_array_equal(toks, np.asarray(ref))
    assert cache.k.device.type == "cpu"
    assert all(x.device.type == "cpu" for _, x in flatten_with_names(server.params)[0])
    mgr2.close()


def test_from_checkpoint_retries_only_io_errors(tmp_path):
    _, _, ref_np = ref_params("tinyllama-1.1b")
    model, _ = port_model("tinyllama-1.1b", ref_np)
    template = transformer.Transformer(model.cfg, device="meta").state_tree()
    mgr = T.CheckpointManager(T.CheckpointConfig(
        root=str(tmp_path), cluster=T.theta_like(2, 1), device="cpu"))
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        raise FileNotFoundError("no step yet")

    mgr.restore_subtree = flaky
    retry = T.RetryPolicy(attempts=3, base_delay=0.001, max_delay=0.001)
    with pytest.raises(FileNotFoundError):
        Server.from_checkpoint(model, mgr, template, retry=retry)
    assert len(calls) == 3          # transient: retried to the budget

    def buggy(*a, **kw):
        calls.append(1)
        raise KeyError("bad template")

    mgr.restore_subtree = buggy
    calls.clear()
    with pytest.raises(KeyError):
        Server.from_checkpoint(model, mgr, template, retry=retry)
    assert len(calls) == 1          # permanent: raised at once
    mgr.close()


# -- serving snapshots across packages --------------------------------------


def _snapshot_run(pkg, model, params, prompt, n_first, n_rest):
    """Greedy prefill + ``n_first`` decode steps (the snapshot point),
    then ``n_rest`` more; returns (tokens, snapshot cache, next token)."""
    if pkg == "jax":
        cache, logits = model.prefill(params, {"tokens": jnp.asarray(prompt)}, s_max=24)
        argmax = lambda lg: np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)
        step = lambda c, tok: model.decode_step(params, c, jnp.asarray(tok))
    else:
        cache, logits = model.prefill(params, {"tokens": t(prompt)}, s_max=24)
        argmax = lambda lg: lg.argmax(-1)[:, None].to(torch.int32).numpy()
        step = lambda c, tok: model.decode_step(params, c, t(tok))
    out, snap = [], None
    tok = argmax(logits)
    for i in range(n_first + n_rest):
        if i == n_first:
            snap = (cache, tok)
        out.append(tok[:, 0])
        logits, cache = step(cache, tok)
        tok = argmax(logits)
    return np.stack(out, 1), snap


@pytest.mark.parametrize("saver,loader", [("jax", "torch"), ("torch", "jax")])
def test_snapshot_restores_across_packages(tmp_path, saver, loader):
    """A serving snapshot {params, DecodeCache, next token} saved by one
    package restores in the other under the same leaf names (the cache's
    fields named ``.k``/``.v``/``.pos``, as JAX's keystr names them) and
    decodes on with the tokens the saver would have emitted."""
    ref_model, ref_p, ref_np = ref_params("tinyllama-1.1b", seed=9)
    model, params = port_model("tinyllama-1.1b", ref_np)
    prompt = tokens(9, 2, 6)
    models = {"jax": (ref_model, ref_p), "torch": (model, params)}
    with torch.inference_mode():
        want, (cache, tok) = _snapshot_run(saver, *models[saver], prompt, 3, 4)
    pkg = {"jax": R, "torch": T}
    kw = {"device": "cpu"} if saver == "torch" else {}
    if saver == "jax":
        snap = {"params": ref_p, "cache": cache, "tok": jnp.asarray(tok)}
    else:
        snap = {"params": params, "cache": cache, "tok": t(tok)}
    mgr = pkg[saver].CheckpointManager(pkg[saver].CheckpointConfig(
        root=str(tmp_path), cluster=pkg[saver].theta_like(2, 2), strategy="stripe_aligned",
        codec="zstd", async_flush=False, **kw))
    mgr.save(1, snap)
    mgr.close()

    kw = {"device": "cpu"} if loader == "torch" else {}
    mgr = pkg[loader].CheckpointManager(pkg[loader].CheckpointConfig(
        root=str(tmp_path), cluster=pkg[loader].theta_like(3, 1), strategy="stripe_aligned",
        codec="zstd", **kw))
    names = [e.name for e in mgr.leaf_catalog(step=1, prefix="['cache']")[1]]
    assert names == ["['cache'].k", "['cache'].v", "['cache'].pos"]
    if loader == "torch":
        template = {"params": params, "cache": model.cache_struct(2, 24), "tok": t(tok)}
        step, got = mgr.restore(template)
        assert isinstance(got["cache"], transformer.DecodeCache)
        lm, lp = model, got["params"]
        cache, tok = got["cache"], got["tok"].numpy()
        with torch.inference_mode():
            logits, cache = lm.decode_step(lp, cache, t(tok))
    else:
        template = {"params": ref_np, "cache": ref_get_model(ref_model.cfg).cache_struct(2, 24),
                    "tok": tok}
        step, got = mgr.restore(jax.tree_util.tree_map(
            lambda x: np.zeros(x.shape, x.dtype), template))
        assert isinstance(got["cache"], ref_transformer.DecodeCache)
        lm, lp = ref_model, jax.tree_util.tree_map(jnp.asarray, got["params"])
        cache = jax.tree_util.tree_map(jnp.asarray, got["cache"])
        tok = np.asarray(got["tok"])
        logits, cache = lm.decode_step(lp, cache, jnp.asarray(tok))
    mgr.close()
    assert step == 1
    # the loader continues: the first resumed token is the snapshot's
    resumed = [tok[:, 0]]
    argmax = ((lambda lg: lg.argmax(-1)[:, None].to(torch.int32).numpy()) if loader == "torch"
              else (lambda lg: np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)))
    tok = argmax(logits)
    for _ in range(3):
        resumed.append(tok[:, 0])
        if loader == "torch":
            with torch.inference_mode():
                logits, cache = lm.decode_step(lp, cache, t(tok))
        else:
            logits, cache = lm.decode_step(lp, cache, jnp.asarray(tok))
        tok = argmax(logits)
    np.testing.assert_array_equal(np.stack(resumed, 1), want[:, 3:])


def test_cache_converters_round_trip():
    ref_model, ref_p, ref_np = ref_params("qwen1.5-0.5b", seed=2, compute_dtype="bfloat16")
    r_cache, _ = ref_model.prefill(ref_p, {"tokens": jnp.asarray(tokens(2, 2, 5))}, s_max=8)
    as_np = jax.tree_util.tree_map(np.asarray, r_cache)
    cache = cache_from_numpy(as_np, "cpu")
    assert isinstance(cache, transformer.DecodeCache) and cache.k.dtype == torch.bfloat16
    back = cache_to_numpy(cache)
    assert isinstance(back, transformer.DecodeCache)
    for a, w in zip(back, as_np):
        assert a.dtype == w.dtype and a.tobytes() == w.tobytes()
    # and back into the reference's type
    again = ref_transformer.DecodeCache(*back)
    assert jax.tree_util.tree_structure(again) == jax.tree_util.tree_structure(r_cache)
