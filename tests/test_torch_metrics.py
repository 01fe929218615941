"""The port's metrics layer against the JAX reference's, on the CPU.

  * the registry's ``snapshot()`` and ``expose()`` (the Prometheus text,
    character for character) and ``console_summary`` of the same
    recorded series, port and reference;
  * ``read_jsonl`` and ``validate_metrics_jsonl`` on broken streams: the
    same verdicts and messages;
  * a ``--metrics-out --metrics-interval 4`` stream of a short paged
    speculative serve through the port's launcher on the CPU: a
    ``serve.metrics`` snapshot every 4 ticks and one at the drain's end,
    valid for the port's ``python -m repro_torch.obs.validate`` and for
    the reference's ``validate_metrics_jsonl``; the byte checks agree
    on the stream's snapshots, and on broken ones;
  * a training stream (``Trainer`` with ``metrics_out``) valid for both
    validators; ``--lint`` validates a port lint report.
"""
from __future__ import annotations

import json
import math

import pytest

from repro.obs import console_summary as ref_console_summary
from repro.obs import read_jsonl as ref_read_jsonl
from repro.obs.registry import MetricsRegistry as RefRegistry
from repro.obs.schema import check_byte_parity as ref_check_byte_parity
from repro.obs.schema import \
    check_paged_pages_parity as ref_check_paged_pages_parity
from repro.obs.schema import validate_metrics_jsonl as ref_validate

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.obs import validate as validate_cli
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.schema import (check_byte_parity,
                                    check_paged_pages_parity,
                                    validate_metrics_jsonl)
from test_torch_serve import one_torch_thread  # noqa: F401

INTERVAL = 4


def _record(reg, inf: bool = True):
    """The same series into either registry: labels to escape, integer
    and fractional values, infinities, a histogram past its buckets."""
    c = reg.counter("ops_total", 'Kernel calls "by" path,\nand op.')
    c.inc(3, op="matmul", path="fused")
    c.inc(2.5, op='pa"ck\\x', path="encode\nrow")
    c.inc()
    g = reg.gauge("occupancy_ratio")
    g.set(0.25)
    g.set(7, slot="1")
    if inf:
        g.set(math.inf, slot="inf")
    g.inc(2, slot="1")
    h = reg.histogram("tick_seconds", "Tick wall time.",
                      buckets=(0.001, 0.5, 2))
    for v in (0.0005, 0.3, 0.3, 9.0):
        h.observe(v, mode="dense")
    h.observe(1e-9)
    reg.histogram("empty_seconds", "")
    return reg


def test_snapshot_expose_and_summary_match_reference():
    got, want = _record(MetricsRegistry()), _record(RefRegistry())
    assert got.expose() == want.expose()
    assert got.snapshot() == want.snapshot()
    json.dumps(got.snapshot())
    assert obs.console_summary(_record(MetricsRegistry(), inf=False)) == (
        ref_console_summary(_record(RefRegistry(), inf=False)))
    assert "inf" in obs.console_summary(got)
    assert [m.name for m in got.metrics()] == [m.name for m in
                                               want.metrics()]
    assert got.metrics()[-1].stats(mode="dense") == want.metrics()[
        -1].stats(mode="dense")
    assert MetricsRegistry().expose() == RefRegistry().expose() == ""
    assert obs.console_summary(MetricsRegistry()) == ref_console_summary(
        RefRegistry())
    for reg in (MetricsRegistry(), RefRegistry()):
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("bad name")
        with pytest.raises(ValueError, match="invalid label name"):
            reg.gauge("ok").set(1, **{"bad-label": 1})
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x")
        reg.reset()
        assert reg.metrics() == []


def test_read_jsonl_and_validator_verdicts_match_reference(tmp_path):
    cases = {
        "empty": "",
        "malformed": "this is not json\n",
        "not_a_record": json.dumps([1, 2]) + "\n",
        "span_no_dur": json.dumps({"kind": "span", "name": "s", "ts": 0})
        + "\n",
        "no_metrics": json.dumps({"kind": "event", "name": "serve.admit",
                                  "ts": 0.0, "attrs": {}}) + "\n",
        "bad_step": json.dumps({"kind": "event", "name": "train.step",
                                "ts": 0.0, "attrs": {"step": 0}}) + "\n",
        "wrong_keys": json.dumps({"kind": "event", "name": "serve.metrics",
                                  "ts": 0.0, "attrs": {"ticks": 1,
                                                       "k": 2}}) + "\n",
    }
    for name, text in cases.items():
        path = tmp_path / f"{name}.jsonl"
        path.write_text(text)
        assert validate_metrics_jsonl(str(path)) == ref_validate(str(path))
        if name == "malformed":
            with pytest.raises(ValueError, match="malformed"):
                list(obs.read_jsonl(str(path)))
        else:
            assert list(obs.read_jsonl(str(path))) == list(
                ref_read_jsonl(str(path)))
    missing = str(tmp_path / "missing.jsonl")
    assert validate_metrics_jsonl(missing)[1][0].startswith("cannot read")


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """A paged speculative serve through the launcher, its metrics
    streamed every INTERVAL ticks."""
    path = str(tmp_path_factory.mktemp("metrics") / "serve.jsonl")
    serve_launcher.main([
        "--arch", "qwen3_8b", "--reduced", "--pack-weights", "--device",
        "cpu", "--paged", "--kv-page-size", "8", "--speculative", "2",
        "--requests", "5", "--max-new-tokens", "6", "--metrics-out", path,
        "--metrics-interval", str(INTERVAL)])
    return path, list(obs.read_jsonl(path))


def test_metrics_stream_validates_for_port_and_reference(stream, capsys):
    path, records = stream
    assert validate_cli.main([path]) == 0
    assert "OK" in capsys.readouterr().out
    counts, errors = ref_validate(path)
    assert errors == []
    assert (counts, errors) == validate_metrics_jsonl(path)
    snaps = [r["attrs"] for r in records if r["name"] == "serve.metrics"]
    ticks = snaps[-1]["ticks"]
    # one snapshot at every INTERVAL-th tick, and the drain's own
    assert [s["ticks"] for s in snaps[:-1]] == list(
        range(INTERVAL, ticks + 1, INTERVAL))
    assert counts["metrics_events"] == ticks // INTERVAL + 1
    assert snaps[-1]["tokens"] == 5 * 6
    assert set(snaps[-1]) == obs.snapshot_keys(paged=True, speculative=True)
    # the registry mirrors the final snapshot; the launcher printed it
    assert obs.REGISTRY.gauge("serve_ticks").value() == ticks
    assert obs.REGISTRY.gauge("serve_weight_passes").value() == snaps[-1][
        "weight_passes"]
    text = obs.REGISTRY.expose()
    assert f"serve_ticks {ticks}" in text


def test_byte_checks_agree_with_reference(stream):
    _, records = stream
    snap = [r["attrs"] for r in records if r["name"] == "serve.metrics"][-1]
    assert snap["weight_passes"] and snap["kv_pages_read"]
    broken = dict(snap, weight_read_bytes_fused=snap[
        "weight_read_bytes_fused"] * 2, kv_pages_read_bytes=snap[
        "kv_pages_read_bytes"] + 10**6, draft_weight_read_bytes_fused=0)
    dense = dict(snap, weight_passes=0, weight_read_bytes_fused=5)
    for s in (snap, broken, dense):
        for prefix in ("", "draft_"):
            assert check_byte_parity(s, prefix) == ref_check_byte_parity(
                s, prefix)
        assert check_paged_pages_parity(s) == ref_check_paged_pages_parity(s)
    assert check_byte_parity(broken) and check_paged_pages_parity(broken)


def test_train_stream_validates_for_port_and_reference(tmp_path):
    from repro_torch.train import Trainer, TrainConfig

    path = str(tmp_path / "train.jsonl")
    tc = TrainConfig(steps=2, seq_len=16, global_batch=2, pack_params=True,
                     log_every=1, metrics_out=path)
    metrics = Trainer(get_config("qwen3_8b").reduced(), tc,
                      device="cpu").run()
    counts, errors = validate_metrics_jsonl(path)
    assert errors == [] and (counts, errors) == ref_validate(path)
    assert counts["metrics_events"] == 1
    assert check_byte_parity(metrics) == []


def test_lint_validates_a_port_report(tmp_path, capsys):
    """``--lint`` checks ``repro_torch.analysis`` reports: a port report
    is valid for the port's validator and for the reference's."""
    from repro.obs.schema import validate_lint_report as ref_validate_lint

    from repro_torch.analysis.report import Finding, LintReport
    rep = LintReport(arch="qwen3_8b", passes=["dispatch"],
                     kv_bits={"kv/layer_0": 16},
                     kv_bounds={"kv/layer_0": 473.25})
    rep.extend([Finding(check="dispatch", severity="info", message="ok"),
                Finding(check="sharding", severity="warning", message="w",
                        path="embed", detail={"tp": 2})])
    path = str(tmp_path / "report.json")
    rep.save(path)
    assert validate_cli.main(["--lint", path]) == 0
    assert f"{path}: OK — 2 findings (0 errors, 1 warnings, 1 infos)" \
        in capsys.readouterr().out
    assert ref_validate_lint(path) == (
        {"findings": 2, "errors": 0, "warnings": 1, "infos": 1}, [])
