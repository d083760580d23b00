"""Each cell's loop end to end on the CPU at smoke sizes: the saves, the
restores from the PFS with L1 gone, the byte comparisons, the metrics."""
from conftest import run_smoke


def test_save_cell_saves_twice_and_restores_the_last_byte_for_byte():
    keep = {}
    res = run_smoke("whisper-small.save", seconds=1.0, keep=keep)
    rec = keep["record"]
    assert res["correct"] is True, res["checks"]
    assert len(rec.saves) == 2
    anchor, delta = (s["stats"] for s in rec.saves)
    assert anchor.flush is not None and delta.flush is not None
    assert all(s["flush_done"] >= s["step_end"] for s in rec.saves)
    assert sum(s["beside_stage"] for s in rec.steps) == 2
    assert res["checks"]["restore_bad_bytes"]["value"] == 0
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    w = res["written_bytes"]
    assert w["l1"] == anchor.stored_bytes + delta.stored_bytes > 0 and w["pfs"] > 0
    assert res["failed"] == 0 and res["attempted"] == len(rec.steps) + 2


def test_resume_cell_restores_from_the_pfs_and_replays_the_step():
    keep = {}
    res = run_smoke("xlstm-350m.resume", seconds=1.0, keep=keep)
    rec = keep["record"]
    assert res["correct"] is True, res["checks"]
    assert len(rec.restores) >= 2 and not rec.saves
    assert all(r["read"] is not None and r["read"].bytes_read > 0 for r in rec.restores)
    assert res["checks"]["restore_bad_bytes"]["value"] == 0
    assert res["checks"]["replay_loss_mismatches"]["value"] == 0
    assert len({s["loss"] for s in rec.steps}) == 1
    assert set(res["metrics"]) == {"restore_s", "setup_s"}


def test_train_cell_bypasses_the_checkpoint_path():
    keep = {}
    res = run_smoke("whisper-small.train", seconds=0.5, keep=keep)
    assert res["correct"] is True, res["checks"]
    assert not keep["record"].saves and res["written_bytes"] == {"l1": 0, "pfs": 0}
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_per_layer_readers_on_a_record():
    """The readers that need no device trace, on the save cell's record;
    those that do give nothing without one."""
    from ckpt_bench import bench

    keep = {}
    run_smoke("whisper-small.save", seconds=1.0, keep=keep)
    rec = keep["record"]
    for name in ("stage_step_slowdown", "codec_mb_per_s", "flush_mb_per_s", "step_mfu",
                 "save_block_s", "persist_s"):
        v = bench.load_reader("metrics", name)(rec)
        assert v is not None and v > 0
    for name in ("fused_precodec_roofline", "device_idle_pct.train"):
        assert bench.load_reader("metrics", name)(rec) is None
    assert bench.load_reader("metrics", "pfs_read_mb_per_s")(rec) is None
