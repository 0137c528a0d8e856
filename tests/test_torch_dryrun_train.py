"""The port's dry run on the reference's train cell
(``tests/test_distributed.py:66``): deepseek-moe-16b x train_4k on a 2x4
("data", "model") fake mesh, in a process of its own, with the
reference's asserts, and rank 0's argument bytes equal to what the
reference's own specs give the same mesh."""
from _torch_dryrun_cell import reference_argument_bytes, run_port_cell


def test_dryrun_small_mesh_train():
    rec = run_port_cell("2x4", "deepseek_moe_16b", "train_4k", "pod")
    assert "skipped" not in rec, rec
    assert rec["n_devices"] == 8
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    assert rec["collectives"]["unknown_trip_conditions"] == 0
    assert rec["memory"]["argument_size_in_bytes"] == \
        reference_argument_bytes("2x4", "deepseek_moe_16b", "train_4k", "pod")
    assert rec["memory"]["peak_memory_in_bytes"] >= rec["memory"]["argument_size_in_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["notes"]["gathers"] == {}
