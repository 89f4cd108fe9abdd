"""Whole runs at smoke size on the CPU, the look for a chip skipped: a
sound run is correct, a run with its timed path broken underneath is
not, and neither is the float8 control put in the program's place.  A
cell and a metric added from new files alone reach the harness."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.tests import smoke

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name", ["smoke.batch", "smoke.chat",
                                  "smoke.train"])
def test_sound_run_is_correct(name):
    # The open loop's window must outlast its first answers on a slow host.
    out = smoke.run(name, seconds=6.0 if name == "smoke.chat" else 3.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"
    if name != "smoke.train":
        # The token gaps' tail is printed for the record, not judged.
        assert "itl_p95_ms" in out["unjudged"]
        assert "itl_p95_ms" not in out["metrics"]


def test_traced_run_reads_no_device_metric_on_the_cpu():
    out = smoke.run("smoke.batch", trace=True)
    assert out["correct"]
    names = set(out["metrics"])
    assert "engine.dispatch_ms_per_tick.chat" in names
    assert not any(n.startswith(("device.", "pageio.", "model."))
                   for n in names)


def _altered_token(monkeypatch):
    from repro_torch.serve import engine
    real = engine.greedy_sample
    monkeypatch.setattr(engine, "greedy_sample",
                        lambda logits: (real(logits) + 1) % logits.shape[-1])


def _state_unchanged(monkeypatch):
    from repro_torch.serve import kv_pages
    monkeypatch.setattr(kv_pages.PageIO, "write_dirty",
                        lambda self, pool, *a, **kw: pool)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged],
                         ids=["token_altered", "state_unchanged"])
@pytest.mark.parametrize("name", ["smoke.batch", "smoke.chat"])
def test_serving_faults_are_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    out = smoke.run(name)
    assert not out["correct"]
    assert out["checks"]["max_logit_gap"]["value"] > \
        out["checks"]["max_logit_gap"]["limit"]


def _train_state_unchanged(monkeypatch):
    from repro_torch.train import train_step
    real = train_step.adamw_update
    monkeypatch.setattr(train_step, "adamw_update",
                        lambda g, p, s, cfg: (p,) + real(g, p, s, cfg)[1:])


def _half_batch(monkeypatch):
    from repro_torch.train import train_step
    real = train_step.value_and_grad

    def half(loss_fn, params, batch):
        n = batch["tgt_tokens"].shape[0] // 2
        return real(loss_fn, params, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(train_step, "value_and_grad", half)


@pytest.mark.parametrize("fault", [_train_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_training_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not smoke.run("smoke.train")["correct"]


def test_serving_control_is_not_correct(monkeypatch):
    """The reference in float8 put in the program's place: its served
    tokens are what float8 puts first."""
    from perfbench.drivers import serve
    from perfbench.reference import lm as ref_lm
    real = serve.logit_gaps

    def control(c, w, sample, device, precisions=("float32",)):
        for r in sample:
            toks = torch.tensor(r["prompt"] + r["generated"][:-1])
            pos = torch.arange(len(r["prompt"]) - 1, toks.shape[0])
            r["generated"] = ref_lm.logits(c, w, toks, pos,
                                           "fp8").argmax(-1).tolist()
        return real(c, w, sample, device, precisions)

    monkeypatch.setattr(serve, "logit_gaps", control)
    assert not smoke.run("smoke.batch")["correct"]


def test_training_control_is_not_correct(monkeypatch):
    """The reference in float8 put in the program's place."""
    from perfbench.drivers import train
    real = train.reference_readings

    def readings(c, wl, seed, device, n, precision="float32", **kw):
        return real(c, wl, seed, device, n, precision, **kw)

    cell = smoke.cell("smoke.train")
    c, wl = cell.config, cell.workload
    ref = readings(c, wl, 5, torch.device("cpu"), 3)
    ctl = readings(c, wl, 5, torch.device("cpu"), 3, "fp8")
    checks = train.compare(wl["correct"], ctl["losses"], ctl["grad_norms"],
                           ctl["change_norms"], ref)
    assert not all(ch["ok"] for ch in checks)


def test_a_cell_and_a_metric_from_new_files_alone(tmp_path):
    """Copy the benchmark, add a workload file, a metric file and their
    entries, and the harness finds them by name; no existing file of the
    copy changes."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    bench = harness.load_bench(ROOT)
    wl = json.loads((ROOT / "perfbench/workloads/"
                     "minitron-4b.short-batch.json").read_text())
    wl["prompt_tokens"] = {"min": 256, "max": 512, "dist": "uniform"}
    (root / "perfbench/workloads/minitron-4b.mid-batch.json").write_text(
        json.dumps(wl))
    (root / "perfbench/metrics/engine.collect_ms_per_tick.batch.py"
     ).write_text("def read(r):\n"
                  "    return r.span_ms_per_unit('decode_collect')\n")
    bench["workloads"].append({"name": "minitron-4b.mid-batch",
                               "config": "minitron-4b",
                               "traffic": "mid-batch", "chips": 1,
                               "why": "a new cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "decode_tok_s":
            m["workloads"].append("minitron-4b.mid-batch")
    bench["per_layer"].append({
        "name": "engine.collect_ms_per_tick.batch", "unit": "ms",
        "better": "lower", "source": "program_span", "layer": "engine",
        "moves": "decode_tok_s", "workloads": ["minitron-4b.mid-batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell(bench, "minitron-4b.mid-batch", root,
                        workloads_dir=root / "perfbench/workloads")
    assert cell.workload["prompt_tokens"]["min"] == 256
    assert {m["name"] for m in cell.end_to_end} == {"decode_tok_s",
                                                    "setup_s"}
    assert [m["name"] for m in cell.per_layer] == [
        "engine.collect_ms_per_tick.batch"]

    class R:
        def span_ms_per_unit(self, name):
            return {"decode_collect": 4.5}[name]

    read = harness.metric_reader("engine.collect_ms_per_tick.batch",
                                 root / "perfbench/metrics")
    assert read(R()) == 4.5
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_per_layer_metric_names_its_cells():
    """Each per-layer entry lists its cells; one without ``workloads`` is
    a fault of the file, not a metric of every cell."""
    bench = harness.load_bench(ROOT)
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells
    bench["per_layer"].append({
        "name": "x.y", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "engine",
        "moves": "decode_tok_s"})
    with pytest.raises(KeyError):
        harness.Cell(bench, "minitron-4b.tenant-chat", ROOT)


def test_run_refuses_without_the_card_or_the_program(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(tmp_path)}
    args = ["--workload", "minitron-4b.tenant-chat", "--seed", "2147483659",
            "--seconds", "1"]
    if not torch.cuda.is_available():
        p = subprocess.run([sys.executable, str(ROOT / "perfbench/run.py"),
                            *args], capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == ""
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "perfbench", bare / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    p = subprocess.run([sys.executable, "perfbench/run.py", *args],
                       capture_output=True, text=True, env=env, cwd=bare,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "minitron-4b.tenant-steady", "--seed", "2147483777",
                        "--seconds", "3"], capture_output=True, text=True,
                       cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
