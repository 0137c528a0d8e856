"""The port's dry run on the reference's multi-pod decode cell
(``tests/test_distributed.py:76``): deepseek-moe-16b x decode_32k on a
2x2x2 ("pod", "data", "model") fake mesh, in a process of its own, with
the reference's asserts, and rank 0's argument bytes equal to what the
reference's own specs give the same mesh."""
from _torch_dryrun_cell import reference_argument_bytes, run_port_cell


def test_dryrun_small_mesh_multipod_decode():
    rec = run_port_cell("2x2x2", "deepseek_moe_16b", "decode_32k", "multipod")
    assert "skipped" not in rec, rec
    assert rec["n_devices"] == 8
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    assert rec["collectives"]["unknown_trip_conditions"] == 0
    assert rec["memory"]["argument_size_in_bytes"] == \
        reference_argument_bytes("2x2x2", "deepseek_moe_16b", "decode_32k", "multipod")
    assert rec["cost"]["flops"] > 0
