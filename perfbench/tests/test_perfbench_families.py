"""The families (``perfbench/families/``): the weights each draws and
the work each counts are pinned at literal values, and a family of
another architecture, added as new files, builds the serving engine and
makes tokens through the driver with its own counts."""

import copy
import hashlib
import json
import math
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import costs, harness, weights
from perfbench.drivers import serve
from perfbench.tests.smoke import DATA

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
CPU = torch.device("cpu")


def _config(path: Path) -> tuple:
    c = json.loads(path.read_text())
    return c, harness.load_family(c["family"])


def _table(shapes: dict) -> str:
    rows = [[k, list(s), f, d] for k, (s, f, d) in shapes.items()]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


# The draw order, names, shapes, fan-ins and types of every leaf, as
# sha256 of their table; at smoke size also each leaf's sum weighted
# linearly from 1 to 2 along its flat order, in float64, at seed 12345.
SHAPES = {
    "minitron-4b":
        "b720b4a13863e56d45ef7dec3675a255f5a7b498ee00732351c0c1381f5a8228",
    "seamless-m4t-large-v2":
        "12ad42cbf88a757a08eb3fb9b1f09046d77a8334e3bcb309725d711111010929",
}
SMOKE = {
    "minitron-4b-smoke.json": (
        "2d23d1b77a34e8b6b9c07eeb732e0e7fd7a82a5c032952bb218e2b1ee7878fa9",
        {"embed": -1.090188595699876, "final_norm": 144.0,
         "norm_mixer": 288.0, "wq": -17.332403677416394,
         "wk": -4.836010945594295, "wv": 1.5624817638410406,
         "wo": -17.98593751785326, "norm_ffn": 288.0,
         "w_gate": 10.759443582819424, "w_up": 5.150130871665673,
         "w_down": 15.678718189730997, "lm_head": 29.404289033970777}),
    "seamless-smoke.json": (
        "b9e9d4f2b5593284711fec83d8a002b924273fddaf597ab96756da1c6d51808d",
        {"embed": -2.6788918531565695, "enc_final_norm": 96.0,
         "dec_final_norm": 96.0, "enc_norm_attn": 192.0,
         "enc_attn_wq": 9.934377551384427,
         "enc_attn_wk": -13.059685431445356,
         "enc_attn_wv": 0.16003061703106702,
         "enc_attn_wo": -12.606397333140489, "enc_norm_ffn": 192.0,
         "enc_w_gate": 15.297085383370892, "enc_w_up": -33.20475337194348,
         "enc_w_down": 24.519644686323392, "dec_norm_attn": 192.0,
         "dec_attn_wq": 6.52554282648101,
         "dec_attn_wk": -23.054821814508056,
         "dec_attn_wv": 12.966858387619212,
         "dec_attn_wo": -4.987939658145775, "dec_norm_cross": 192.0,
         "dec_cross_wq": -10.069815869762726,
         "dec_cross_wk": 12.397565146743297,
         "dec_cross_wv": -4.931221898557388,
         "dec_cross_wo": -2.6778882940003856, "dec_norm_ffn": 192.0,
         "dec_w_gate": 19.869403396378665, "dec_w_up": 52.20682207320567,
         "dec_w_down": -5.8109904860777775}),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_full_configs_draw_the_same_leaves(name):
    """At full size the draw is too large for the CPU; the same table
    through the same ``weights.make`` gives the same tensors."""
    c, fam = _config(CONFIGS / f"{name}.json")
    assert _table(fam.shapes(c)) == SHAPES[name]


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_smoke_configs_draw_the_same_weights(name):
    c, fam = _config(DATA / name)
    table, sums = SMOKE[name]
    assert _table(fam.shapes(c)) == table
    w = weights.make(fam.shapes(c), 12345, CPU)
    assert list(w) == list(sums)
    for k, v in w.items():
        x = v.double().flatten()
        got = float((x * torch.linspace(1, 2, x.numel(),
                                        dtype=torch.float64)).sum())
        assert got == pytest.approx(sums[k], rel=1e-12, abs=1e-12), k


def test_counts_of_the_full_configs():
    c, fam = _config(CONFIGS / "minitron-4b.json")
    assert fam.decode_flops(c, 1000) == 9012510720.0
    assert fam.decode_flops(c, 1700) == 9287761920.0
    assert fam.prefill_flops(c, 1536) == 13703395147776.0
    assert fam.prefill_flops(c, 100) == 863915212800.0
    assert fam.page_bytes(c, 8, 64) == 1048576
    assert costs.page_crossing_work(fam.page_bytes(c, 8, 64), 64, 1696,
                                    8) == (1786787136, 61196992512.0)
    c, fam = _config(CONFIGS / "seamless-m4t-large-v2.json")
    assert fam.train_flops(c, 16, 512, 256) == 62881492107264.0


def test_counts_of_the_smoke_configs():
    c, fam = _config(DATA / "minitron-4b-smoke.json")
    assert fam.decode_flops(c, 30) == 391680.0
    assert fam.prefill_flops(c, 12) == 4483584.0
    assert fam.page_bytes(c, 4, 64) == 1024
    assert fam.page_bytes(c, 8, 64) == 2048
    c, fam = _config(DATA / "seamless-smoke.json")
    assert fam.train_flops(c, 4, 16, 8) == 59203584.0


def test_a_family_of_another_architecture_from_new_files_alone(tmp_path):
    """The port's MoE LM (olmoe-1b-7b at smoke size): a config file and a
    family file of the test data, copied into a checkout's
    ``perfbench/``; the driver builds the engine with it, five ticks make
    tokens, and the window's FLOPs and page work are that family's
    counts, not the dense LM's."""
    for src, dst in (("olmoe-1b-7b-smoke.json", "configs/olmoe-1b-7b.json"),
                     ("moe_lm.py", "families/moe_lm.py")):
        (tmp_path / "perfbench" / dst).parent.mkdir(parents=True,
                                                     exist_ok=True)
        shutil.copy(DATA / src, tmp_path / "perfbench" / dst)
    bench = copy.deepcopy(harness.load_bench())
    bench["configs"].append({
        "name": "olmoe-1b-7b-smoke", "source": "smoke",
        "file": "perfbench/configs/olmoe-1b-7b.json",
        "reduced": [], "why": "smoke"})
    bench["workloads"].append({"name": "smoke.batch",
                               "config": "olmoe-1b-7b-smoke",
                               "traffic": "batch", "chips": 1,
                               "why": "smoke"})
    cell = harness.Cell(bench, "smoke.batch", tmp_path, workloads_dir=DATA)
    c, fam = cell.config, cell.family
    assert fam.__file__ == str(tmp_path / "perfbench/families/moe_lm.py")
    eng, tr, w, ranges = serve.build(cell, 2_200_000_019, CPU, trace=True)
    assert set(w) >= {"router", "w_gate", "w_up", "w_down"}
    assert w["w_gate"].shape == (2, 8, 64, 32)
    ranges.on = True             # the page counts of a traced segment
    try:
        tr.run_ticks(5)
    finally:
        ranges.on = False
        ranges.close()
    recs = list(tr.recs.values())
    assert sum(len(r["times"]) for r in recs) > 0

    def flops(family):
        return sum(family.prefill_flops(c, len(r["prompt"])) if k == 0
                   else family.decode_flops(c, len(r["prompt"]) + k)
                   for r in recs for k in range(len(r["times"])))

    got = serve._model_flops(cell, tr, -math.inf, math.inf)
    assert got == flops(fam) > 0
    assert got != flops(harness.load_family("dense_lm"))
    read, written = tr.work["read"], tr.work["written"]
    assert read > 0 and written > 0
    page = fam.page_bytes(c, 8, 64)
    assert page == 2 * 2 * 8 * 4 * 16 * 2
    nbytes, ops = serve._page_work(cell, read, written)
    assert nbytes == (read + written) * (page + costs.PAGE_MAC_BYTES)
    assert ops == costs.crossing_ops((read + written) * page, 64)
