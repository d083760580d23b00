"""deepseek-v2-lite [moe] — MLA (no query compression), one leading dense
layer, 64 routed experts top-6 + 2 shared, YaRN rope
[hf:deepseek-ai/DeepSeek-V2-Lite].

The port's own architecture (the JAX package has no MLA), so it is not in
``ARCHS``, the list the two packages share; ``get_config`` and the
launcher's ``--arch`` find it by name. ``router_aux_weight`` (the config's
``aux_loss_alpha``) is 0.001, DeepSeek-V2's value.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, RopeScaling


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944, vocab_size=102400, norm_eps=1e-6, rope_theta=10000.0,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        rope_scaling=RopeScaling(factor=40, original_max_position_embeddings=4096,
                                 beta_fast=32, beta_slow=1, mscale_all_dim=0.707),
        first_k_dense_replace=1,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, expert_d_ff=1408,
                      shared_d_ff=2816, dropless=True, router_aux_weight=0.001),
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    """Every width cut, one leading dense layer and two MoE layers; the
    layer holds 4 of the router's 16 experts (the first of 4 shares)."""
    return config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab_size=256,
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        moe=MoEConfig(n_experts=16, top_k=3, n_shared=2, expert_d_ff=24, shared_d_ff=48,
                      n_held=4, dropless=True, router_aux_weight=0.001),
        param_dtype="float32", compute_dtype="float32",
    )
