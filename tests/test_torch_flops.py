"""The port's analytic cell terms (`repro_torch.launch.flops.cell_terms`)
and model FLOPs (`launch.inputs.model_flops`) against the JAX package's,
for every arch and shape of the registry: the FLOPs, HBM bytes and
collective bytes equal (the same arithmetic), and the times those give
on one H100 (989 TFLOP/s bfloat16 for the LMs, 67 TFLOP/s float32
otherwise, 3.35 TB/s, 450 GB/s a direction of NVLink)."""
import pytest

from repro.configs import registry as jregistry
from repro.launch import flops as jflops
from repro.launch import inputs as jinputs
from repro_torch import configs
from repro_torch.launch import flops, inputs

CELLS = [(a, s.name) for a in jregistry.list_archs()
         for s in jregistry.get_arch(a).shapes]
# (chips, model_ways, dp_ways, options): one card, and the reference's
# default 256-chip cell with its options
LAYOUTS = ((1, 1, 1, {}), (256, 16, 16, {}),
           (256, 16, 16, {"lm": dict(naive_flash=True, cp_attention=True),
                          "ann": dict(mode_b=True, int8_adc=True)}))


@pytest.mark.parametrize("aid,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_terms_and_model_flops_equal_the_reference(aid, shape):
    arch, jarch = configs.get_arch(aid), jregistry.get_arch(aid)
    s, js = arch.shape(shape), jarch.shape(shape)
    assert inputs.model_flops(arch, s) == jinputs.model_flops(jarch, js)
    for chips, mw, dw, opts in LAYOUTS:
        kw = opts.get(arch.family, {})
        got = flops.cell_terms(arch, s, chips=chips, model_ways=mw,
                               dp_ways=dw, **kw)
        want = jflops.cell_terms(jarch, js, chips=chips, model_ways=mw,
                                 dp_ways=dw, **kw)
        for k in ("flops", "hbm_bytes", "coll_bytes"):
            assert got[k] == want[k], (k, chips, kw)
        peak = 989e12 if getattr(arch.model, "dtype", "") == "bfloat16" \
            else 67e12
        assert got["t_compute"] == got["flops"] / peak
        assert got["t_memory"] == got["hbm_bytes"] / 3.35e12
        assert got["t_collective"] == got["coll_bytes"] / 450e9
        assert got["bottleneck"] == max(
            ("t_compute", "t_memory", "t_collective"), key=got.get)


def test_the_gnn_step_bound_on_one_card():
    """ogb_products' step: ~175 GB at 3.35 TB/s, bound by the bytes."""
    arch = configs.get_arch("graphsage-reddit")
    t = flops.cell_terms(arch, arch.shape("ogb_products"), chips=1,
                         model_ways=1, dp_ways=1)
    assert t["bottleneck"] == "t_memory"
    assert 170e9 < t["hbm_bytes"] < 180e9
    assert 0.050 < t["t_memory"] < 0.054
