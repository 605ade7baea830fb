"""Whole runs of each cell at a tiny size on the CPU, skipping only the
harness's look for a chip: the shape of the last line, and ``correct``
coming out false with the timed path broken underneath (a code altered
where it is produced, half of each batch left out, a published chunk
lost) and with the lower-precision control in the program's place. On the
card, the same with the published widths and the TF32 control."""

import json

import pytest

from bench_testkit import READY, cuda, run_tiny, tiny_inputs  # noqa: F401
from pbkit import runner
from pbkit import trace as pbtrace

CELLS = ["engine-web.8cb", "yodas2-shard.32cb", "engine-chunks.32cb"]
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(cell, trace, tmp_path):
    man, _, _, _, _ = tiny_inputs(cell)
    run, result, line = run_tiny(cell, tmp_path, trace=trace)
    assert run.error is None
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    json.dumps(line)
    if cell in READY:
        # not in BENCHMARK.json: read its metrics by their readers
        want = set(READY[cell][3] if trace else READY[cell][2])
        values = {m: runner.reader(m).read(run) for m in want}
        line["metrics"] = {m: {"value": v, "unit": "-"} for m, v in values.items() if v is not None}
    else:
        want = {m["name"] for m in (man.per_layer(cell) if trace else man.end_to_end(cell))}
    got = set(line["metrics"])
    # the CPU has no peak and no device trace: those shares are left out
    device_only = {"mfu.encode", "mfu.shard", "seanet_roofline.encode", "rvq_roofline.encode",
                   "device_idle.encode", "device_idle.shard"}
    assert want - device_only <= got <= want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["checks"]["code_gap_max"]["value"] == 0.0
    assert ("breakdown" in line) is trace
    if trace:
        assert list(line["breakdown"]) == list(pbtrace.BREAKDOWN)
        # one SEANet call's valid lengths per device batch, the real rows among them
        assert run.traced_rows and sum(map(len, run.traced_rows)) >= sum(u["items"] for u in run.traced_units)
    if cell.startswith("engine"):
        # the counters as the window left them, not the traced segment's too
        assert run.stats.utterances == sum(u["items"] for u in run.units)


def _alter_a_code(monkeypatch):
    from tokenize_audio_tpu_torch.mimi import model

    inner = model.split_rvq_encode

    def altered(params, emb, k, backend="kernel"):
        codes = inner(params, emb, k, backend=backend).clone()
        codes[:, -1, 0] = (codes[:, -1, 0] + 1) % params["semantic"]["embed"].shape[1]
        return codes

    monkeypatch.setattr(model, "split_rvq_encode", altered)


def _leave_out_half_the_batch(monkeypatch):
    from tokenize_audio_tpu_torch.engine import encoder

    inner = encoder.mimi_encode

    def half(params, cfg, audio, valid=None, **kw):
        audio = audio.clone()
        audio[audio.shape[0] // 2:] = 0
        return inner(params, cfg, audio, valid, **kw)

    monkeypatch.setattr(encoder, "mimi_encode", half)


def _lose_a_chunk(monkeypatch):
    from tokenize_audio_tpu_torch.hub import LocalHub

    inner = LocalHub.upload_batch

    def lossy(self, items):
        items = list(items)
        return inner(self, items[:-1])

    monkeypatch.setattr(LocalHub, "upload_batch", lossy)


FAULTS = {"altered": _alter_a_code, "half_batch": _leave_out_half_the_batch, "lost": _lose_a_chunk}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in sorted(FAULTS)
    # only the shard cell publishes to a hub
    if f != "lost" or c == "yodas2-shard.32cb"
])
def test_a_broken_timed_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    _, result, line = run_tiny(cell, tmp_path, seconds=0.1)
    assert line["correct"] is False
    assert line["failed"] > 0 or line["checks"]["code_gap_max"]["value"] > line["checks"]["code_gap_max"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_is_not_correct(cell, tmp_path):
    _, result, line = run_tiny(cell, tmp_path, seconds=0.1, mode={"compute_dtype": "bfloat16"})
    gap = line["checks"]["code_gap_max"]
    assert line["correct"] is False and gap["value"] > gap["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_sound_is_correct_and_tf32_is_not(cell, tmp_path, cuda):
    """The published widths on the card, a short window of tiny traffic:
    the control (the program's TF32 path) has to fail the check."""
    man, c, cfg, mix, params = tiny_inputs(cell)
    cfg = man.config(c.config)
    for mode, want in (({}, True), ({"matmul_precision": "high"}, False)):
        run = runner.Run(c.name, cfg, mix, params, 2**31 + 99, 0.5, cuda, str(tmp_path), mode)
        result = runner.execute(run, runner.driver(mix["driver"]), False, 0.0)
        assert result["correct"] is want, result["checks"]
