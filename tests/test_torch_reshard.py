"""The elastic reshard of a checkpoint from a (1, 4) mesh of 4 gloo ranks
onto a (4, 2) mesh of 8 (the port's ``tests/test_checkpoint.py:100``), and
a mesh that does not match its world (``_torch_dist``)."""
import numpy as np

from _torch_dist import run_ranks


def test_elastic_reshard_across_meshes(tmp_path):
    """Saved on a (1, 4) mesh by 4 ranks, restored onto a (4, 2) mesh by 8:
    byte for byte, at the placements asked for."""
    ckpt = str(tmp_path / "ckpt")
    assert run_ranks("elastic_save", 4, tmp_path, timeout=60, ckpt=ckpt) == [True] * 4
    res = run_ranks("elastic_restore", 8, tmp_path, timeout=60, ckpt=ckpt)
    want = {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8),
            "b": np.ones(8, np.float32)}
    for full, places, local, step in res:
        assert step == 1
        for k in want:
            assert full[k].dtype == want[k].dtype
            assert full[k].tobytes() == want[k].tobytes()
            got, asked = places[k]
            assert got == asked
        assert local == {"w": (2, 4), "b": (8,)}


def test_a_mesh_that_does_not_match_the_world_raises(tmp_path):
    msgs = run_ranks("mesh_mismatch", 2, tmp_path, timeout=60)
    assert all(m and "needs 8 ranks" in m for m in msgs), msgs
