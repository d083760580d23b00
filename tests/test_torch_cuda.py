"""The port's CUDA kernels and device path on the card.

Imports torch and NumPy only, so it runs where JAX is absent. Every test
needs a CUDA device (the kernels have no CPU mode) and skips without
one; on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import os

# cuBLAS reads this when it makes its handle; the bit-equality of two
# train runs needs its fixed workspace
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import pytest
import torch

from repro_torch.core import CheckpointConfig, CheckpointManager, theta_like
from repro_torch.core.precodec import dequantize_tree, dequantize_tree_reference, quantize_tree
from repro_torch.kernels.checksum.ops import checksum_u32, checksum_u32_plain, digest_array
from repro_torch.kernels.delta.ops import xor_delta, xor_delta_plain
from repro_torch.kernels.fused.ops import fused_precodec, fused_precodec_plain
from repro_torch.kernels.quantize.ops import (
    dequantize,
    dequantize_plain,
    quantize,
    quantize_plain,
)
from repro_torch.utils.treelib import flatten_with_names

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _words(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device="cuda", generator=g)


@pytest.mark.parametrize(
    "n,cw",
    [(3 * 2048 + 777, 2048), (1024, 1024), (100_003, 262_144), ((1 << 21) + 5, 1 << 21)],
)
def test_fused_kernel_matches_plain(cuda, n, cw):
    cur = _words(n, n)
    base = cur.clone()
    base[::7] ^= 1
    got = fused_precodec(cur, base, chunk_words=cw)
    ref = fused_precodec_plain(cur, base, chunk_words=cw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_quantize_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device="cuda").manual_seed(7)
    x = (torch.randn(5 * 4096 + 300, device="cuda", generator=g) * 3).to(dtype)
    x[:128] = 0
    q, s = quantize(x)
    flat = torch.nn.functional.pad(x.float(), (0, (-x.numel()) % 4096))
    rq, rs = quantize_plain(flat.view(-1, 128))
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert not q[0].any() and float(s[0]) == 0.0


@pytest.mark.parametrize("n", [1, 3, 1025, 100_003, 3 * (1 << 20) + 7])
def test_checksum_kernel_matches_plain(cuda, n):
    """Aligned, and three views that start off a 16-byte boundary (the
    kernel's scalar head); more than 2**20 words wraps the index."""
    w = _words(n + 3, n)
    for start in range(4):
        v = w[start : start + n]
        assert torch.equal(checksum_u32(v), checksum_u32_plain(v)), start
    launches = checksum_u32.launches
    assert not checksum_u32(w[:0]).any() and checksum_u32.launches == launches


def test_digest_array_kernel_matches_plain(cuda):
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(4099, device="cuda", generator=g) * 100
    views = {
        "f32": x, "f32_unaligned": x[1:], "f32_unaligned3": x[3:],
        "bf16_odd_offset": x.to(torch.bfloat16)[1:], "f16": x.to(torch.float16),
        "int8_ragged": x.to(torch.int8)[1:], "int64": x.to(torch.int64)[1:],
        "f64": x.double(), "bool": x > 0, "scalar": x[7],
    }
    for name, v in views.items():
        assert torch.equal(digest_array(v).cpu(), digest_array(v.cpu())), name


@pytest.mark.parametrize(
    "n,frac", [(1, 1.0), (1023, 0.5), (4096, 0.0), (4096, 1.0), (100_003, 0.02)]
)
def test_xor_delta_kernel_matches_plain(cuda, n, frac):
    cur = _words(n, n)
    prev = cur.clone()
    g = torch.Generator(device="cuda").manual_seed(n)
    hit = torch.rand(n, device="cuda", generator=g) < frac
    prev[hit] ^= 0x1234
    d, count = xor_delta(cur, prev)
    rd, rcount = xor_delta_plain(cur, prev)
    assert torch.equal(d, rd)
    assert int(count) == int(rcount) == int(hit.sum())


def _same_floats(a, b):
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]
    )


@pytest.mark.parametrize("n", [1, 77, 128, 129, 3 * 4096 + 77, 4 * 4096])
def test_dequantize_kernel_matches_plain(cuda, n):
    """``n`` cut mid-block, a NaN scale, a zero block, a negative scale."""
    g = torch.Generator(device="cuda").manual_seed(5)
    q, s = quantize(torch.randn(4 * 4096, device="cuda", generator=g) * 3)
    s[1] = float("nan")
    q[2], s[2] = 0, 0.0
    s[3] = -s[3]
    got = dequantize(q, s, n=n)
    assert got.shape == (n,)
    assert _same_floats(got, dequantize_plain(q, s, n=n))
    assert _same_floats(got, (q.float() * s[:, None]).reshape(-1)[:n])


def test_dequantize_tree_reference_on_the_card(cuda):
    rng = np.random.default_rng(1)
    state = {
        "w": torch.from_numpy(rng.standard_normal((64, 300)).astype(np.float32)).cuda(),
        "h": torch.from_numpy(rng.standard_normal((40, 130)).astype(np.float32))
        .to(torch.bfloat16).cuda(),
        "small": torch.ones(37, device="cuda"),
        "i": torch.arange(511, dtype=torch.int32, device="cuda"),
    }
    qtree = quantize_tree(state)
    launches = dequantize.launches
    ref = dequantize_tree_reference(qtree, state)
    assert dequantize.launches == launches + 2
    host = dequantize_tree(qtree, state)    # unquantized leaves pass through
    for k, t in state.items():
        assert ref[k].device.type == "cuda" and ref[k].dtype == t.dtype, k
        assert torch.equal(ref[k].cpu(), host[k].cpu()), k


def test_wrappers_refuse_unaligned_input(cuda):
    x = _words(4096 + 1, 1)
    with pytest.raises(ValueError, match="aligned"):
        fused_precodec(x[1:], x[1:], chunk_words=1024)
    with pytest.raises(ValueError, match="aligned"):
        xor_delta(x[1:], x[1:])


@pytest.mark.parametrize("precodec", ["none", "int8"])
def test_device_round_trip(cuda, tmp_path, precodec):
    rng = np.random.default_rng(0)
    state = {
        "w": torch.from_numpy(rng.standard_normal((64, 300)).astype(np.float32)).cuda(),
        "h": torch.from_numpy(rng.standard_normal((40, 130)).astype(np.float32))
        .to(torch.bfloat16).cuda(),
        "flag": torch.from_numpy(rng.random(513) < 0.5).cuda(),
        "step": torch.tensor(1, dtype=torch.int32, device="cuda"),
    }
    cfg = dict(root=str(tmp_path), cluster=theta_like(2, 2), codec="zstd+delta",
               chunk_size=4096, device_precodec=True, precodec=precodec)
    mgr = CheckpointManager(CheckpointConfig(**cfg))
    launches = fused_precodec.launches
    copies = {}
    for step in (1, 2):
        copies[step] = {n: t.cpu().clone() for n, t in flatten_with_names(state)[0]}
        mgr.stage(step, state)
        state["w"][:8].add_(1.0)      # in place, after stage()
        state["step"].add_(1)
        mgr.save(step, state)
    mgr.wait()
    mgr.close()
    assert fused_precodec.launches == launches + 2
    mgr = CheckpointManager(CheckpointConfig(**cfg))
    for step in (1, 2):
        _, tree = mgr.restore(state, step=step)
        for n, t in flatten_with_names(tree)[0]:
            assert t.device.type == "cuda"
            if precodec == "none" or t.dtype not in (torch.float32, torch.bfloat16):
                assert torch.equal(t.cpu(), copies[step][n]), n
    mgr.close()


def test_two_tenants_stage_at_once_on_the_card(cuda, tmp_path):
    """Two managers of one control plane stage and save from two threads
    at once: each restores its own state, and no launch count is lost."""
    import threading

    from repro_torch.control import ControlPlane

    cp = ControlPlane(str(tmp_path), device="cuda", max_pending_flushes=2)
    mgrs = [cp.register_job(f"job{i}", theta_like(2, 2), codec="zstd+delta",
                            chunk_size=4096, device_precodec=True) for i in range(2)]
    states = [{"w": torch.from_numpy(np.random.default_rng(i).standard_normal((256, 300))
                                     .astype(np.float32)).cuda(),
               "step": torch.tensor(i, dtype=torch.int32, device="cuda")} for i in range(2)]
    copies = [{n: t.cpu().clone() for n, t in flatten_with_names(st)[0]} for st in states]
    launches = fused_precodec.launches
    barrier = threading.Barrier(2)
    errors = []

    def run(mgr, state):
        try:
            barrier.wait()
            mgr.stage(1, state)
            mgr.save(1, state)
            mgr.wait()
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=a) for a in zip(mgrs, states)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [] and all(not m.flush_errors for m in mgrs)
    assert fused_precodec.launches == launches + 2
    for mgr, state, copy in zip(mgrs, states, copies):
        _, tree = mgr.restore(state, step=1)
        for n, t in flatten_with_names(tree)[0]:
            assert t.device.type == "cuda" and torch.equal(t.cpu(), copy[n]), n
    cp.close()


def _smoke(compute="float32"):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.train import OptConfig, TrainConfig

    cfg = get_smoke_config("qwen1.5-0.5b").replace(compute_dtype=compute)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    return cfg, get_model(cfg), tcfg


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One step of qwen's smoke config (float32) from the same state on
    the same batch: metrics to 1e-5; each parameter's AdamW direction to
    0.1 lr and each leaf's update to 1e-3 of its norm (the tolerances of
    tests/test_torch_train.py, for the same reason); mu and nu to 1e-4
    of their largest element."""
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.utils.convert import train_state_from_numpy, tree_to_numpy

    cfg, model, tcfg = _smoke()
    start = tree_to_numpy(init_train_state(model, torch.Generator().manual_seed(0), tcfg, "cpu"))
    batch = SyntheticTokens(DataConfig(vocab_size=256, seq_len=64, global_batch=4),
                            device="cpu").next()
    out = {}
    for dev in ("cpu", "cuda"):
        state = train_state_from_numpy(start, model, dev)
        state, m = build_train_step(model, tcfg)(state, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (tree_to_numpy(state), {k: float(v) for k, v in m.items()})
    (c, cm), (g, gm) = out["cpu"], out["cuda"]
    for k in ("loss", "grad_norm", "lr"):
        assert gm[k] == pytest.approx(cm[k], rel=1e-5), k
    lr = cm["lr"]
    for (n, x), (_, y), (_, p0) in zip(flatten_with_names(g["params"])[0],
                                      flatten_with_names(c["params"])[0],
                                      flatten_with_names(start["params"])[0]):
        np.testing.assert_allclose(x, y, rtol=0, atol=0.1 * lr, err_msg=n)
        du, dc = x.astype(np.float64) - p0, y.astype(np.float64) - p0
        assert np.linalg.norm(du - dc) <= 1e-3 * np.linalg.norm(dc), n
    for group in ("mu", "nu"):
        for (n, x), (_, y) in zip(flatten_with_names(g["opt"][group])[0],
                                  flatten_with_names(c["opt"][group])[0]):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-4 * np.abs(y).max(), err_msg=n)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_train_runs_on_the_card_are_bit_equal(cuda, compute):
    """Two runs of three steps under deterministic algorithms give the
    same bits (the bf16 case includes the embedding gather's bf16
    scatter-add in backward)."""
    from repro_torch.data import DataConfig
    from repro_torch.launch.train import run
    from repro_torch.utils.convert import tree_to_numpy

    cfg, _, tcfg = _smoke(compute)
    data_cfg = DataConfig(vocab_size=256, seq_len=64, global_batch=4)
    a, b = (run(cfg, data_cfg, tcfg, None, steps=3, ckpt_every=0, device="cuda", log=lambda _: None)
            for _ in range(2))
    assert a.losses == b.losses
    for (n, x), (_, y) in zip(flatten_with_names(tree_to_numpy(a.state))[0],
                              flatten_with_names(tree_to_numpy(b.state))[0]):
        assert x.tobytes() == y.tobytes(), n


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_moe_forward_backward_on_the_card_is_bit_equal(cuda, compute):
    """The MoE smoke model's loss and gradients, twice under deterministic
    algorithms on a batch whose routing drops slots: the same bits (the
    dispatch writes unique slots; the combine gather's backward and the
    embedding's accumulate in a fixed order). No op on the path raises
    under the mode."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.models import get_model

    cfg = get_smoke_config("qwen2-moe-a2.7b").replace(compute_dtype=compute)
    model = get_model(cfg)
    module = model.init(torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, dtype=torch.int32)
    leaves = [p for _, p in flatten_with_names(module.state_tree())[0]]
    out = []
    with deterministic_algorithms():
        for _ in range(2):
            loss, parts = model.loss(module.state_tree(), {"tokens": tokens.cuda()})
            out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert float(parts["aux"]) > 0
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_generate_on_the_card_matches_the_cpu(cuda):
    """Server.generate of qwen's smoke config (float32) on the card
    keeps params and cache on the card; the CPU, teacher-forced on the
    card's tokens, gives each step's logits within 1e-4 (float32, summed
    in another order; tokens are compared only within one device)."""
    from repro_torch.serve import ServeConfig, Server
    from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy

    _, model, _ = _smoke()
    host = tree_to_numpy(model.init(torch.Generator().manual_seed(0), "cpu").state_tree())
    prompt = np.random.default_rng(0).integers(0, 256, (3, 40)).astype(np.int32)
    server = Server(model, tree_from_numpy(host, "cuda"), ServeConfig(max_new_tokens=8))
    toks, cache = server.generate({"tokens": prompt})
    assert cache.k.device.type == "cuda" and cache.pos.device.type == "cuda"
    again, _ = server.generate({"tokens": prompt})
    np.testing.assert_array_equal(again, toks)
    params = {"cpu": tree_from_numpy(host, "cpu"), "cuda": server.params}
    logits = {}
    with torch.inference_mode():
        for dev, p in params.items():
            c, lg = model.prefill(p, {"tokens": torch.as_tensor(prompt, device=dev)}, s_max=48)
            out = [lg.cpu()]
            for i in range(toks.shape[1] - 1):
                lg, c = model.decode_step(p, c, torch.as_tensor(toks[:, i : i + 1], device=dev))
                out.append(lg.cpu())
            logits[dev] = torch.stack(out)
    assert torch.equal(logits["cuda"].argmax(-1).T.int(), torch.as_tensor(toks))
    np.testing.assert_allclose(logits["cuda"].numpy(), logits["cpu"].numpy(), rtol=0, atol=1e-4)


def test_snapshot_resume_on_the_card(cuda, tmp_path):
    """A serving snapshot (params + DecodeCache + next token) saved with
    the device pre-codec (fused_precodec launched) and restored from the
    PFS into a fresh server on the card decodes on with the tokens of
    the uninterrupted run."""
    from repro_torch.models.transformer import DecodeCache, Transformer
    from repro_torch.serve import ServeConfig, Server

    cfg, model, _ = _smoke("bfloat16")
    params = model.init(torch.Generator(device="cuda").manual_seed(3), "cuda").state_tree()
    prompt = np.random.default_rng(1).integers(0, 256, (4, 24)).astype(np.int32)
    server = Server(model, params, ServeConfig(max_new_tokens=10, s_max=40))
    want, _ = server.generate({"tokens": prompt})
    with torch.inference_mode():
        cache, logits = model.prefill(params, {"tokens": torch.as_tensor(prompt, device="cuda")},
                                      s_max=40)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        for _ in range(5):
            logits, cache = model.decode_step(params, cache, tok)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
    before = fused_precodec.launches
    mgr = CheckpointManager(CheckpointConfig(
        root=str(tmp_path), cluster=theta_like(2, 2), codec="zstd+delta", device_precodec=True))
    mgr.save(1, server.snapshot_state(cache) | {"tok": tok})
    mgr.wait()
    assert not mgr.flush_errors and fused_precodec.launches > before
    mgr.close()
    mgr = CheckpointManager(CheckpointConfig(root=str(tmp_path), cluster=theta_like(3, 1)))
    for node in range(2):
        mgr.local.drop_node(node)
    _, got = mgr.restore({"params": Transformer(cfg, device="meta").state_tree(),
                          "cache": model.cache_struct(4, 40),
                          "tok": torch.empty((4, 1), device="meta")})
    mgr.close()
    assert isinstance(got["cache"], DecodeCache) and got["cache"].k.device.type == "cuda"
    resumed = Server(model, got["params"], server.cfg)
    cache, tok, out = got["cache"], got["tok"], []
    with torch.inference_mode():
        for _ in range(5):
            out.append(tok[:, 0].cpu().numpy())
            logits, cache = model.decode_step(resumed.params, cache, tok)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
    np.testing.assert_array_equal(np.stack(out, 1), want[:, 5:])


@pytest.mark.parametrize("arch", ["xlstm-350m", "recurrentgemma-2b"])
def test_recurrent_forward_backward_on_the_card_is_bit_equal(cuda, arch):
    """The xLSTM's (the mLSTM chunks, the sLSTM time loop) and Griffin's
    (the RG-LRU's doubling scan, windowed attention) smoke models in bf16
    compute: loss and gradients twice under deterministic algorithms, with
    remat, give the same bits, and no op on the path raises under the
    mode."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.models import get_model

    cfg = get_smoke_config(arch).replace(compute_dtype="bfloat16")
    model = get_model(cfg)
    module = model.init(torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, dtype=torch.int32)
    leaves = [p for _, p in flatten_with_names(module.state_tree())[0]]
    out = []
    with deterministic_algorithms():
        for _ in range(2):
            loss, _ = model.loss(module.state_tree(), {"tokens": tokens.cuda()})
            out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert bool(torch.isfinite(out[0][0]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_whisper_forward_backward_on_the_card_is_bit_equal(cuda, compute):
    """Whisper's smoke model (the encoder over stub frames, always
    recomputed in backward; the decoder's self- and cross-attention and
    the tied embedding): loss and gradients twice under deterministic
    algorithms give the same bits, and no op on the path raises under the
    mode (the embedding gather's backward included)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.models import get_model

    cfg = get_smoke_config("whisper-small").replace(compute_dtype=compute)
    model = get_model(cfg)
    module = model.init(torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 64), generator=g,
                                     dtype=torch.int32).cuda(),
             "frames": torch.randn((4, cfg.enc_seq, cfg.d_model), generator=g).cuda()}
    leaves = [p for _, p in flatten_with_names(module.state_tree())[0]]
    out = []
    with deterministic_algorithms():
        for _ in range(2):
            loss, _ = model.loss(module.state_tree(), batch)
            out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert bool(torch.isfinite(out[0][0]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_slstm_graph_replays_the_eager_loop(cuda):
    """The sLSTM's time loops on the card replay as CUDA graphs: the
    forward (with and without the saved gates) and the written-out
    backward give the bits of the same loops run eagerly."""
    from repro_torch.models import xlstm

    xlstm.release_graphs()      # those an earlier test's training left
    g = torch.Generator(device="cuda").manual_seed(2)
    s, h, b, hd = 48, 4, 3, 32
    pre_x = torch.randn((s, h, b, 4 * hd), generator=g, device="cuda")
    r = 0.4 * torch.randn((h, hd, 4 * hd), generator=g, device="cuda") / hd ** 0.5
    carry = (torch.zeros((h, b, hd), device="cuda"), torch.zeros((h, b, hd), device="cuda"),
             torch.full((h, b, hd), 1e-6, device="cuda"), torch.full((h, b, hd), -1e30, device="cuda"))
    for keep in (False, True):
        eager = xlstm._scan_forward(pre_x, r, *carry, keep=keep)
        for _ in range(2):      # the capture, then a replay
            graphed = xlstm._run(xlstm._scan_forward, (pre_x, r, *carry), keep=keep)
            assert all(torch.equal(x, y) for x, y in zip(graphed, eager))
        # another option replaced the loop's graph: one is held per loop
        assert list(xlstm._GRAPHS) == ["_scan_forward"]
    saved = (r, *carry[:3], eager[0], *eager[5:])
    grads = (torch.randn_like(eager[0]), *(torch.randn_like(carry[0]) for _ in range(4)))
    eager_b = xlstm._scan_backward(*saved, *grads)
    for _ in range(2):
        graphed_b = xlstm._run(xlstm._scan_backward, saved + grads)
        assert all(torch.equal(x, y) for x, y in zip(graphed_b, eager_b))
    assert sorted(xlstm._GRAPHS) == ["_scan_backward", "_scan_forward"]
    xlstm.release_graphs()


def test_xlstm_serving_and_training_hold_bounded_device_memory(cuda):
    """Prefill captures no graph, and once each prompt length has run
    (the libraries' one-off workspaces), prefill at those lengths leaves
    ``torch.cuda.memory_allocated`` where it was; train steps at several
    sequence lengths hold one graph per sLSTM loop, each replaced when
    the length changes, and after a first pass over the lengths the
    memory after a step at a length equals that after the last one
    there."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model, xlstm

    cfg = get_smoke_config("xlstm-350m").replace(compute_dtype="bfloat16")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cuda").state_tree()
    g = torch.Generator().manual_seed(1)
    xlstm.release_graphs()

    def prefill(s):
        tokens = torch.randint(0, cfg.vocab_size, (3, s), generator=g, dtype=torch.int32)
        with torch.inference_mode():
            state, logits = model.prefill(params, {"tokens": tokens.cuda()})
        del state, logits
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    lengths = (8, 16, 24, 40, 7)
    for s in lengths:
        prefill(s)
    assert xlstm._GRAPHS == {}
    before = prefill(lengths[-1])
    for s in lengths * 2:
        assert prefill(s) == before, s
    assert xlstm._GRAPHS == {}

    def train(s):
        tokens = torch.randint(0, cfg.vocab_size, (2, s), generator=g, dtype=torch.int32)
        loss, _ = model.loss(params, {"tokens": tokens.cuda()})
        loss.backward()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    for s in (32, 16, 48):  # each shape once: the libraries' one-off workspaces
        train(s)
    first = train(32)
    for s in (16, 48, 32):
        held = train(s)
        assert sorted(xlstm._GRAPHS) == ["_scan_backward", "_scan_forward"]
    assert held == first
    xlstm.release_graphs()
