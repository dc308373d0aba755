"""The port's roofline and dry-runs (``launch/{roofline,dryrun,pp_dryrun}``)
on the CPU.

``model_flops`` and the SNN's ``snn_stream_cost`` equal the reference's;
``roofline_terms`` and ``streaming_roofline`` equal the reference's with
the reference's machine model patched in-process to the port's (its
``ici_bw`` set to the port's NVLink ``link_bw``).  The dry-runs count on
meta tensors: the twin of the reference's slow ``test_dryrun_one_cell``
(mamba2-780m ``long_500k`` on the 512-chip mesh: ``ok``, 512 chips, a
positive compute term, and the 80 GB fit), one ``train_4k`` cell whose
counted FLOPs exceed ``6ND`` by the recomputation (``useful_ratio`` in
(0.5, 1]), and the pipeline dry-run's schedule.
"""
import dataclasses
import json

import pytest

from repro.configs.registry import SHAPES as REF_SHAPES
from repro.configs.registry import get_config as ref_get_config
from repro.launch import roofline as ref_roofline
from repro.launch.hlo_analysis import CollectiveStat, HloAnalysis
from repro.models.snn import SNNConfig as RefSNNConfig
from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun, pp_dryrun, roofline
from repro_torch.launch.mesh import HW
from repro_torch.models.snn import SNNConfig

from _torch_parity import SMALL_SPEC


@pytest.fixture
def ref_on_port_hw(monkeypatch):
    monkeypatch.setattr(ref_roofline, "HW", {**HW, "ici_bw": HW["link_bw"]})


def test_model_flops_equal_the_reference():
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert roofline.model_flops(get_config(arch), SHAPES[name]) == \
                ref_roofline.model_flops(ref_get_config(arch), REF_SHAPES[name])


@pytest.mark.parametrize("density", [1.0, 0.5, 0.25])
def test_snn_stream_cost_equals_the_reference(density):
    for cfg, ref_cfg in ((SNNConfig(), RefSNNConfig()),
                         (SNNConfig(**SMALL_SPEC), RefSNNConfig(**SMALL_SPEC))):
        assert roofline.snn_stream_cost(cfg, density) == \
            ref_roofline.snn_stream_cost(ref_cfg, density)


@pytest.mark.parametrize("batch,chips", [(1, 1), (64, 1), (64, 4)])
def test_streaming_roofline_equals_the_reference_on_the_port_hw(
        ref_on_port_hw, batch, chips):
    for density in (1.0, 0.5):
        assert roofline.streaming_roofline(SNNConfig(), density, batch, chips) == \
            ref_roofline.streaming_roofline(RefSNNConfig(), density, batch, chips)


@pytest.mark.parametrize("arch,shape", [("llama3-8b", "train_4k"),
                                        ("qwen2-moe-a2.7b", "prefill_32k"),
                                        ("mamba2-780m", "long_500k")])
def test_roofline_terms_equal_the_reference_on_the_port_hw(ref_on_port_hw,
                                                           arch, shape):
    counts = roofline.CellCounts(dot_flops=3.2e14, bytes_accessed=7.5e9,
                                 collective_bytes=2.1e9, wire_bytes=3.7e9)
    analysis = HloAnalysis(
        dot_flops=counts.dot_flops, bytes_accessed=counts.bytes_accessed,
        collectives={"all-gather": CollectiveStat(1, counts.collective_bytes,
                                                  counts.wire_bytes)},
        warnings=[])
    for chips in (256, 512):
        assert roofline.roofline_terms(get_config(arch), SHAPES[shape], counts,
                                       chips) == \
            ref_roofline.roofline_terms(ref_get_config(arch), REF_SHAPES[shape],
                                        analysis, chips)


def test_the_machine_model_is_an_h100():
    assert HW["peak_flops_bf16"] == 989e12 and HW["hbm_bw"] == 3.35e12
    assert HW["link_bw"] == 450e9 and HW["hbm_bytes"] == 80 * 10**9


def test_dryrun_one_cell(tmp_path):
    """The reference's slow test_dryrun_one_cell, through the CLI, in
    process (it counts on meta tensors in a few seconds)."""
    rc = dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                      "--mesh", "multi", "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads(
        (tmp_path / "multi" / "mamba2-780m__long_500k.json").read_text())
    assert rec["ok"] and rec["chips"] == 512
    assert rec["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["roofline"]["terms_s"]["compute"] > 0
    assert rec["memory"]["fits_80g_hbm"]
    assert rec["roofline"]["hw"] == HW["name"]
    assert rec["counts"] == rec["roofline"]["per_device"]


def test_dryrun_train_cell_counts_the_recomputation():
    rec = dryrun.run_cell("qwen1.5-0.5b", "train_4k", "single")
    r = rec["roofline"]
    assert rec["ok"] and rec["chips"] == 256
    # full recomputation: ~8ND (+ attention) counted against 6ND
    assert 0.5 < r["useful_ratio"] <= 1.0
    assert r["bottleneck"] == "compute"
    assert rec["memory"]["fits_80g_hbm"]
    assert rec["memory"]["alias_bytes"] > 0     # the donated train state
    mem = rec["memory"]
    assert mem["peak_live_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                      + mem["temp_bytes"] - mem["alias_bytes"])


def test_dryrun_skips_cells_skipped_by_design(tmp_path):
    rec = dryrun.run_cell("llama3-8b", "long_500k", "single")
    assert rec["ok"] and rec["skipped"] and "sub-quadratic" in rec["reason"]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "llama3-8b", "--out", str(tmp_path)])


def test_param_collectives_follow_the_ring_model():
    from repro_torch.distributed.sharding import Mesh, PartitionSpec, named_tree
    import torch

    mesh = Mesh((2, 4, 8), ("pod", "data", "model"))
    params = {"w": torch.empty(64, 32, device="meta"),
              "n": torch.empty(32, device="meta")}
    specs = {"w": PartitionSpec("data", "model"), "n": PartitionSpec()}
    sh = named_tree(specs, mesh)
    coll, wire = dryrun.param_collectives(params, sh, "prefill")
    gathered = 64 * 32 * 2 / 8                     # bf16, model-sharded
    assert coll == gathered and wire == gathered * 3 / 4
    coll, wire = dryrun.param_collectives(params, sh, "train")
    grad_shard = 64 * 32 * 4 / 8 / 4
    norm_grad = 32 * 4
    assert coll == 2 * gathered + 2 * grad_shard + norm_grad
    assert wire == (2 * gathered * 3 / 4 + grad_shard * 3 + 2 * grad_shard / 2
                    + 2 * norm_grad * 7 / 8)


def test_pp_dryrun_record(tmp_path):
    assert pp_dryrun.main(["--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "pp" / "llama3-8b__prefill_pp.json").read_text())
    assert rec["ok"] and rec["ticks"] == 23 == 16 + 8 - 1
    assert rec["bubble_fraction"] == 7 / 23
    assert rec["stage_calls"] == 23 * 8
    assert rec["mesh"] == {"stage": 8, "data": 2, "model": 16}
    assert set(rec["terms_s"]) == {"compute", "memory", "collective"}
    assert rec["terms_s"]["compute"] > 0 and rec["memory"]["fits_80g_hbm"]
    with pytest.raises(ValueError):
        pp_dryrun.run("mamba2-780m")


def test_cell_counts_record_is_the_roofline_input():
    assert [f.name for f in dataclasses.fields(roofline.CellCounts)] == \
        ["dot_flops", "bytes_accessed", "collective_bytes", "wire_bytes"]
