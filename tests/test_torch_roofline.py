"""The port's roofline against the reference's: ``analytic.cell_cost``,
the dry run's ``count_params`` and ``model_flops`` for every cell of
``all_cells()``, and ``hlo``'s walk (a copy) on the compiled HLO of a
jitted ``lax.scan`` and on a hand-written module with collectives inside
a while loop."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

import repro.launch.dryrun as RD
import repro_torch.launch.dryrun as PD
from repro.configs.base import all_cells as r_all_cells
from repro.roofline import analytic as RA
from repro.roofline import hlo as RH
from repro_torch.configs.base import all_cells as p_all_cells
from repro_torch.roofline import analytic as PA
from repro_torch.roofline import hlo as PH

CELLS = [(c.name, s.name) for c, s, _, _ in r_all_cells()]


@pytest.mark.parametrize("arch", sorted({a for a, _ in CELLS}))
def test_cell_cost_params_and_model_flops_equal_the_reference(arch):
    for (rc, rs, rok, _), (pc, ps, pok, _) in zip(r_all_cells(), p_all_cells()):
        if rc.name != arch:
            continue
        assert (pc.name, ps.name, pok) == (rc.name, rs.name, rok)
        a, b = PA.cell_cost(pc, ps), RA.cell_cost(rc, rs)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), (arch, rs.name)
        n = PD.count_params(pc)
        assert n == RD.count_params(rc)
        assert PD.model_flops(pc, ps, n["active"]) == RD.model_flops(rc, rs, n["active"])


_LOOP = """HloModule m

%cond (p: (s32[], f32[8])) -> pred[] {
  %p = (s32[], f32[8]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(12)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

%body (p: (s32[], f32[8])) -> (s32[], f32[8]) {
  %p = (s32[], f32[8]) parameter(0)
  %x = f32[8] get-tuple-element(%p), index=1
  %ar = f32[8] all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[32] all-gather(%x), replica_groups=[2,4]<=[8], dimensions={0}
  %cp = bf16[8] collective-permute(%x), source_target_pairs={{0,1},{1,0}}
  ROOT %t = (s32[], f32[8]) tuple(%i, %ar)
}

ENTRY %main (a: f32[8]) -> f32[8] {
  %a = f32[8] parameter(0)
  %rs = f32[2] reduce-scatter(%a), replica_groups={{0,1,2,3}}, dimensions={0}
  %w = (s32[], f32[8]) while(%init), condition=%cond, body=%body
  ROOT %r = f32[8] get-tuple-element(%w), index=1
}
"""


def _scan_hlo() -> str:
    def f(x):
        return jax.lax.scan(lambda c, _: (jnp.sin(c) * 2.0, None), x, None, length=7)[0]
    return jax.jit(f).lower(jnp.ones((4, 4))).compile().as_text()


@pytest.mark.parametrize("text", ["loop", "scan"])
def test_hlo_walk_equals_the_reference(text):
    hlo = _LOOP if text == "loop" else _scan_hlo()
    for group in (1, 8):
        assert PH.collective_summary(hlo, group) == RH.collective_summary(hlo, group)
    assert PH.while_trip_counts(hlo) == RH.while_trip_counts(hlo)
    for base in PH.COLLECTIVES:
        for R, g in ((96.0, 4), (1.0, 1), (7.0, 0)):
            assert PH._wire_bytes(base, R, g) == RH._wire_bytes(base, R, g)
    if text == "loop":
        s = PH.collective_summary(hlo, 8)
        assert s["counts"]["all-reduce"] == 12 and s["unknown_trip_conditions"] == 0
        assert PH.while_trip_counts(hlo) == [("body", 12)]
