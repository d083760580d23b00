"""DeepSeek-V2-Lite in the port against the plain float32 reference of
``tests/torch_reference/deepseek_v2.py`` (the JAX package has no MLA),
on the CPU at the smoke size, seeded.

Float32 throughout: the port and the reference compute the same sums in
other orders (the port's dropless layer gathers and groups the held
slots, the reference runs every held expert on every token under its
gate), so values agree to float32 rounding, and a tolerance is stated
where one is used. Routing counts and the choice of experts agree
exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_reference import deepseek_v2 as ref

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.train import deterministic_algorithms
from repro_torch.models import get_model, layers, mla, moe
from repro_torch.models.config import MoEConfig
from repro_torch.models.sharding import P, is_spec, param_specs
from repro_torch.train import OptConfig, TrainConfig, build_train_step, init_train_state
from repro_torch.train.train_step import MOE_COUNTERS
from repro_torch.utils import telemetry
from repro_torch.utils.treelib import flatten_with_names, tree_leaves, tree_map, unflatten

ROOT = Path(__file__).resolve().parents[1]
ARCH = "deepseek-v2-lite"
# float32 sums of a few hundred terms in other orders
ATOL = 2e-5


def cfg_dict(cfg):
    return dataclasses.asdict(cfg)


def build(cfg=None, seed=0):
    cfg = cfg or get_smoke_config(ARCH)
    model = get_model(cfg)
    module = model.init(torch.Generator().manual_seed(seed), "cpu")
    return cfg, model, module


def plain(tree):
    """The tree's leaves as plain float32 tensors that take gradients."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    return tree.detach().clone().float().requires_grad_(True)


def tokens(seed, b=3, s=24, v=256):
    return torch.randint(0, v, (b, s), generator=torch.Generator().manual_seed(seed)).int()


def named(tree):
    return dict(flatten_with_names(tree)[0])


def test_logits_and_loss_match_reference():
    cfg, model, module = build()
    tok = tokens(1)
    params = module.state_tree()
    with torch.no_grad():
        got_logits, got_aux = model.forward(params, {"tokens": tok})
        got_loss = model.loss(params, {"tokens": tok}, remat=False)[0]
        want_logits, want_aux = ref.forward(plain(params), cfg_dict(cfg), tok)
        want_loss = ref.loss(plain(params), cfg_dict(cfg), tok)
    torch.testing.assert_close(got_logits, want_logits, rtol=0, atol=ATOL)
    torch.testing.assert_close(got_aux, want_aux, rtol=0, atol=1e-7)
    torch.testing.assert_close(got_loss, want_loss, rtol=0, atol=ATOL)
    assert float(got_aux) > 0


@pytest.mark.parametrize("remat", [True, False])
def test_every_gradient_matches_reference(remat):
    """Every leaf's gradient within 1e-4 of the largest entry of the
    reference's gradient of that leaf."""
    cfg, model, module = build()
    tok = tokens(2)
    params = module.state_tree()
    loss = model.loss(params, {"tokens": tok}, remat=remat)[0]
    names, leaves = zip(*flatten_with_names(params)[0])
    got = torch.autograd.grad(loss, leaves)
    mine = plain(params)
    want = torch.autograd.grad(ref.loss(mine, cfg_dict(cfg), tok),
                               [named(mine)[n] for n in names])
    assert len(names) == 27
    for n, g, w in zip(names, got, want):
        assert float(w.abs().max()) > 0, n
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()), msg=n)


def reference_adamw(params, cfg, batches, opt):
    """Three steps of the port's AdamW (``train/optimizer.py``'s formula)
    on the reference's loss, in float32."""
    leaves, treedef = flatten_with_names(params)
    p = {n: t.detach().clone().float().requires_grad_(True) for n, t in leaves}
    mu = {n: torch.zeros_like(t) for n, t in p.items()}
    nu = {n: torch.zeros_like(t) for n, t in p.items()}
    losses = []
    for count, tok in enumerate(batches):
        loss = ref.loss(unflatten(treedef, list(p.values())), cfg_dict(cfg), tok)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = opt.grad_clip / gnorm if gnorm > opt.grad_clip else 1.0
            warm = min((count + 1) / opt.warmup_steps, 1.0)
            lr = opt.lr * warm      # cosine is 1 in the warm-up
            bc1, bc2 = 1 - opt.beta1 ** (count + 1), 1 - opt.beta2 ** (count + 1)
            for n, x in p.items():
                g = grads[n] * scale
                mu[n] = opt.beta1 * mu[n] + (1 - opt.beta1) * g
                nu[n] = opt.beta2 * nu[n] + (1 - opt.beta2) * g * g
                x -= lr * ((mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + opt.eps)
                           + opt.weight_decay * x)
    return losses, p


def test_three_adamw_steps_match_reference():
    cfg, model, _ = build()
    opt = OptConfig(lr=1e-2, warmup_steps=100)
    tcfg = TrainConfig(opt=opt)
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg, "cpu")
    start = tree_map(lambda t: t.detach().clone(), state["params"])
    step = build_train_step(model, tcfg)
    batches = [tokens(10 + j) for j in range(3)]
    losses = []
    with deterministic_algorithms():
        for tok in batches:
            state, m = step(state, {"tokens": tok})
            losses.append(float(m["loss"]))
    want_losses, want = reference_adamw(start, cfg, batches, opt)
    assert losses == pytest.approx(want_losses, rel=1e-5)
    start = named(start)
    for n, x in named(state["params"]).items():
        moved = float((want[n].detach() - start[n]).abs().max())
        assert moved > 0, n
        # Adam divides each entry by its own second moment, so an entry
        # whose gradient is near the rounding of the sums moves by up to
        # lr either way: 1 % of the leaf's largest move (0.3 % seen)
        torch.testing.assert_close(x, want[n].detach(), rtol=0, atol=1e-2 * moved, msg=n)


def test_yarn_ramp_and_scale():
    """DeepSeek-V2-Lite's YaRN: the ramp runs from pair 10 to pair 23 of
    the rope head's 32, the port's frequencies are the reference's, and
    the scores' scale is 192 ** -0.5 times m ** 2, m = 0.1 * 0.707 *
    ln 40 + 1."""
    cfg = get_config(ARCH)
    assert layers.yarn_correction_range(cfg.rope_scaling, 64, 10000.0) == (10, 23)
    assert ref.yarn_ramp(cfg_dict(cfg)) == (10, 23)
    freqs = mla.inv_freq(cfg)
    torch.testing.assert_close(freqs, ref.inv_freq(cfg_dict(cfg)), rtol=1e-6, atol=0)
    base = layers.rope_freqs(64, 10000.0)
    assert torch.equal(freqs[:11], base[:11])
    torch.testing.assert_close(freqs[23:], base[23:] / 40, rtol=1e-6, atol=0)
    assert bool((freqs[11:23] < base[11:23]).all() and (freqs[11:23] > base[11:23] / 40).all())
    m = 0.1 * 0.707 * torch.log(torch.tensor(40.0, dtype=torch.float64)).item() + 1
    assert m == pytest.approx(1.2608, abs=1e-4)
    assert mla.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert ref.mscale(cfg_dict(cfg)) == pytest.approx(m, rel=1e-12)


def share_cfg(m, start):
    return dataclasses.replace(m, held_start=start)


def layer_params(module, layer=0):
    return {k: v[layer].detach() for k, v in module.state_tree()["layers"]["moe"].items()}


@pytest.mark.parametrize("tied", [False, True], ids=["random-router", "tied-router"])
def test_shares_add_up_to_the_uncut_layer(tied):
    """The 4 shares of the smoke layer (4 of 16 experts each): their
    routed parts plus the shared experts once equal the reference's
    uncut layer, and every share gives the same aux loss; with a random
    router, and with a router of zeros, whose equal probabilities the
    greedy top-k breaks by the lower index (every slot to the first
    share)."""
    cfg = get_smoke_config(ARCH)
    m = cfg.moe
    shares = m.n_experts // m.held
    uncut_cfg = cfg.replace(moe=dataclasses.replace(m, n_held=0))
    _, _, uncut = build(uncut_cfg, seed=3)
    p = layer_params(uncut)
    if tied:
        p["router"] = torch.zeros_like(p["router"])
    x = torch.randn(2, 20, cfg.d_model, generator=torch.Generator().manual_seed(4))
    shared = layers.swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"])
    total, auxes, held = shared.clone(), [], []
    for i in range(shares):
        part = {k: (v[i * m.held:(i + 1) * m.held] if k.startswith("w_") else v)
                for k, v in p.items()}
        out, aux, counts = moe.moe_ffn_dropless(x, part, share_cfg(m, i * m.held))
        total += out - shared
        auxes.append(aux)
        held.append(int(counts[1]))
    with torch.no_grad():
        want, want_aux = ref.moe(p, cfg_dict(uncut_cfg), x)
    torch.testing.assert_close(total, want, rtol=0, atol=ATOL)
    assert all(torch.equal(a, auxes[0]) for a in auxes)
    torch.testing.assert_close(auxes[0], want_aux, rtol=0, atol=1e-8)
    slots = x.shape[0] * x.shape[1] * m.top_k
    assert sum(held) == slots
    if tied:
        assert held[0] == slots


def test_no_slot_is_dropped_when_every_token_routes_to_held_experts():
    """A router that sends every token to experts 0-2 (all held by the
    first share): every slot is computed, expert 0 gets every token,
    and the output is the reference's."""
    cfg = get_smoke_config(ARCH)
    m = cfg.moe
    _, _, module = build(seed=5)
    p = layer_params(module)
    router = torch.full((cfg.d_model, m.n_experts), -1.0)
    router[:, :m.top_k] = torch.tensor([3.0, 2.0, 1.0])
    p["router"] = router
    x = torch.rand(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(6))
    out, _, counts = moe.moe_ffn_dropless(x, p, m)
    t = x.shape[0] * x.shape[1]
    assert counts.tolist() == [t * m.top_k, t * m.top_k, t]
    assert t > moe.capacity(m, x.shape[1]) * x.shape[0]    # the capacity path drops here
    with torch.no_grad():
        want, _ = ref.moe(p, cfg_dict(cfg), x, held=range(m.held))
    torch.testing.assert_close(out, want, rtol=0, atol=ATOL)


def bench_model_config():
    sys.path.insert(0, str(ROOT))
    try:
        from ckpt_bench import bench
    finally:
        sys.path.remove(str(ROOT))
    raw = json.loads((ROOT / "ckpt_bench" / "configs" / f"{ARCH}.json").read_text())
    return raw, bench.model_config(raw)


def test_benchmark_config_loads_and_counts_535m_parameters():
    """The benchmark's JSON (nested ``moe`` and ``rope_scaling`` dicts)
    through ``ckpt_bench.bench.model_config``: the published widths, 8
    of 64 experts held, 535,060,992 parameters."""
    raw, cfg = bench_model_config()
    assert isinstance(cfg.moe, MoEConfig) and cfg.moe.held == raw["n_routed_experts"] == 8
    assert cfg.moe.n_experts == raw["published"]["n_routed_experts"] == 64
    assert cfg.rope_scaling == get_config(ARCH).rope_scaling
    full = get_config(ARCH)
    same = ("d_model", "n_heads", "d_ff", "kv_lora_rank", "qk_nope_head_dim",
            "qk_rope_head_dim", "v_head_dim", "norm_eps", "rope_theta", "first_k_dense_replace")
    assert all(getattr(cfg, k) == getattr(full, k) for k in same)
    assert dataclasses.replace(cfg.moe, n_held=0) == full.moe
    assert get_model(cfg).param_count() == 535_060_992


def test_param_count_counts_the_dense_layer_and_the_share():
    """Active parameters: the leading dense layer has no experts to
    leave out; each MoE layer leaves out, of its held experts, all but
    the top_k * held / n_experts a token uses on average."""
    full = get_model(get_config(ARCH))
    expert = 3 * 2048 * 1408
    assert full.param_count() == 15_706_484_224
    assert full.param_count(active_only=True) == full.param_count() - 26 * 58 * expert
    _, cfg = bench_model_config()
    share = get_model(cfg)
    assert share.param_count(active_only=True) == share.param_count() - 4 * (8 - 0.75) * expert
    qwen = get_model(get_config("qwen2-moe-a2.7b"))
    assert qwen.param_count(active_only=True) == (
        qwen.param_count() - 24 * 3 * 2048 * 1408 * (60 - 4))


def test_counters_equal_the_reference_routing_counts():
    """A train step hands the layers' routing counts to the recorder on
    the device; drained, they are the reference's counts of the same
    forward."""
    cfg, model, module = build(seed=7)
    tok = tokens(8, b=2, s=32)
    want = ref.routing_counts(plain(module.state_tree()), cfg_dict(cfg), tok)
    state = init_train_state(model, torch.Generator().manual_seed(7), TrainConfig(), "cpu")
    step = build_train_step(model, TrainConfig())
    telemetry.drain()
    telemetry.enable()
    try:
        step(state, {"tokens": tok})
        counts = telemetry.drain()[1]
    finally:
        telemetry.disable()
    assert [counts[n] for n in MOE_COUNTERS] == want
    assert want[0] == 2 * 32 * cfg.moe.top_k * cfg.n_moe_layers
    assert 0 < want[2] <= want[1] < want[0]


def test_sharding_rules_of_the_new_leaves():
    """Experts over "model" as the 4-D MoE stacks are; the latent norm
    replicated; the latent projections as the other stacked weights."""
    model = get_model(get_config(ARCH))
    specs = dict(flatten_with_names(param_specs(model, {"data": 2, "model": 8}),
                                    is_leaf=is_spec)[0])
    assert specs["['layers']['moe']['w_gate']"] == P(None, "model", "data", None)
    assert specs["['layers']['moe']['w_down']"] == P(None, "model", "data", None)
    assert specs["['layers']['moe']['router']"] == P(None, "data", None)
    for stack in ("layers", "dense_layers"):
        assert specs[f"['{stack}']['ln_kv']"] == P()
        assert specs[f"['{stack}']['w_dkv']"] == P(None, "data", "model")
        assert specs[f"['{stack}']['w_ukv']"] == P(None, "data", "model")
        assert specs[f"['{stack}']['wo']"] == P(None, "model", "data")
    assert specs["['dense_layers']['w_down']"] == P(None, "model", "data")


def test_serving_mla_raises_a_clear_error():
    cfg, model, module = build()
    params = module.state_tree()
    for call in (lambda: model.prefill(params, {"tokens": tokens(1)}),
                 lambda: model.init_cache(params, 2, 16),
                 lambda: model.cache_struct(2, 16)):
        with pytest.raises(NotImplementedError, match="latent attention"):
            call()


def test_run_resumes_bit_exact(tmp_path):
    """The trainer's loop: steps 1-4 saving 2 and 4 with the device
    pre-codec, then a fresh run restores step 2 (the ``dense_layers``
    stack beside ``layers``) and replays 3-4 to the same bits."""
    import repro_torch.core as T
    from repro_torch.data import DataConfig
    from repro_torch.launch.train import run

    cfg = get_smoke_config(ARCH)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=4))
    ckpt = T.CheckpointConfig(root=str(tmp_path), cluster=T.theta_like(2, 2),
                              codec="zstd+delta", chunk_size=8192,
                              device_precodec=True, device="cpu")
    logs = []
    a = run(cfg, data_cfg, tcfg, ckpt, steps=4, ckpt_every=2, device="cpu", log=logs.append)
    assert [s.step for s in a.saves] == [2, 4] and not a.flush_errors
    b = run(cfg, data_cfg, tcfg, ckpt, steps=4, ckpt_every=0, resume=2, device="cpu",
            log=logs.append)
    assert b.restored_step == 2 and b.losses == a.losses[2:]
    for x, y in zip(tree_leaves(b.state), tree_leaves(a.state)):
        assert torch.equal(x.view(-1).view(torch.uint8), y.view(-1).view(torch.uint8))
    assert "dense_layers" in a.state["params"]


def test_cli_train_and_resume(tmp_path):
    """``python -m repro_torch.launch.train --arch deepseek-v2-lite
    --smoke``: 3 steps with a checkpoint, then ``--resume`` to 6 prints
    the same steps 4-6 as an uninterrupted 6-step run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--global-batch", "4",
              "--seq-len", "32", "--strategy", "stripe_aligned", "--codec", "zstd",
              "--lr", "1e-2"]

    def cli(root, args):
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *common,
                            "--root", str(root), *args],
                           capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-2000:]
        return [line for line in r.stdout.splitlines() if line.startswith("step")], r.stdout

    whole, _ = cli(tmp_path / "whole", ["--steps", "6", "--ckpt-every", "0"])
    first, out1 = cli(tmp_path / "split", ["--steps", "3", "--ckpt-every", "3"])
    second, out2 = cli(tmp_path / "split", ["--steps", "6", "--ckpt-every", "3", "--resume"])
    assert "[ckpt]" in out1 and "[resume] restored step 3" in out2

    def losses(lines):
        return [line.split("step_time")[0] for line in lines]

    assert losses(first + second) == losses(whole)
    assert len(whole) == 6
