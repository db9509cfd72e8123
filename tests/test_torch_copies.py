"""The port's framework-free copies equal the reference's: plans, noise
schedules, tokenizer ids and config fields. Exact, no tolerance: the copies
run the same Python and numpy code."""

import dataclasses

import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs import sd_unet as jsd
from repro.core import schedules as jsched
from repro.core import selective as jsel
from repro.data import synthetic as jsyn
from repro.data import tokenizer as jtok
from repro_torch.configs import base as tbase
from repro_torch.configs import sd_unet as tsd
from repro_torch.core import schedules as tsched
from repro_torch.core import selective as tsel
from repro_torch.data import synthetic as tsyn
from repro_torch.data import tokenizer as ttok


def _plan(p):
    return (p.total_steps, p.guidance_scale,
            tuple((s.start, s.stop, s.mode.value) for s in p.segments),
            p.optimized_steps, p.denoiser_passes(), p.is_suffix,
            [m.value for m in p.modes()])


# fractions on the .5 boundaries of round_half_up for T = 10 and T = 50
FRACTIONS = [0.0, 0.05, 0.15, 0.2, 0.25, 0.3, 0.35, 0.45, 0.5, 0.55, 0.75, 0.99, 1.0]


@pytest.mark.parametrize("T", [1, 4, 10, 20, 50])
def test_full_and_suffix_plans_equal(T):
    assert _plan(tsel.GuidancePlan.full(T, 7.5)) == _plan(jsel.GuidancePlan.full(T, 7.5))
    for f in FRACTIONS:
        assert _plan(tsel.GuidancePlan.suffix(T, f, 3.0)) == \
            _plan(jsel.GuidancePlan.suffix(T, f, 3.0)), (T, f)


@pytest.mark.parametrize("T", [4, 10, 50])
def test_window_plans_and_errors_equal(T):
    for a in FRACTIONS:
        for b in FRACTIONS:
            try:
                ref = _plan(jsel.GuidancePlan.window(T, a, b))
            except ValueError:
                with pytest.raises(ValueError):
                    tsel.GuidancePlan.window(T, a, b)
                continue
            assert _plan(tsel.GuidancePlan.window(T, a, b)) == ref, (T, a, b)


def test_sweep_and_round_half_up_equal():
    for T in (10, 50):
        assert [_plan(p) for p in tsel.sweep(T, FRACTIONS)] == \
            [_plan(p) for p in jsel.sweep(T, FRACTIONS)]
    for x in (0.5, 1.5, 2.5, 3.5, 2.4999, -0.5, 12.5):
        assert tsel.round_half_up(x) == jsel.round_half_up(x)
    assert [p.optimized_steps for p in tsel.sweep(10, [0.05, 0.15, 0.25, 0.35])] \
        == [1, 2, 3, 4]


def test_plan_cursor_walk_equal():
    for f in (0.0, 0.3, 1.0):
        tc = tsel.PlanCursor.for_request(10, f, 7.5)
        jc = jsel.PlanCursor.for_request(10, f, 7.5)
        while not jc.done:
            assert (tc.mode.value, tc.cost, tc.remaining_passes(), tc.at_transition) == \
                (jc.mode.value, jc.cost, jc.remaining_passes(), jc.at_transition)
            tc.advance()
            jc.advance()
        assert tc.done and tc.passes_executed == jc.passes_executed


@pytest.mark.parametrize("T", [100, 1000])
def test_noise_schedules_equal(T):
    t, j = tsched.NoiseSchedule.sd_default(T), jsched.NoiseSchedule.sd_default(T)
    for name in ("betas", "alphas", "alphas_bar"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for n in (1, 6, 20, 50):
        np.testing.assert_array_equal(t.spaced_timesteps(n), j.spaced_timesteps(n))
    np.testing.assert_array_equal(tsched.cosine_beta_schedule(T),
                                  jsched.cosine_beta_schedule(T))


def test_tokenizer_ids_equal():
    texts = tsyn.CLASS_PROMPTS + ["", "A Red DISC, with 3 don't-s!", "x " * 40]
    assert tsyn.CLASS_PROMPTS == jsyn.CLASS_PROMPTS
    assert tsyn.N_CLASSES == jsyn.N_CLASSES
    for vocab, length in ((4096, 16), (4096, 77), (512, 8)):
        ids = ttok.encode_batch(texts, vocab, length)
        np.testing.assert_array_equal(ids, jtok.encode_batch(texts, vocab, length))
        assert ids.dtype == np.int32
    assert ttok.encode("a b c", 100, add_bos=False) == jtok.encode("a b c", 100, add_bos=False)


def _fields(obj):
    """Field by field, the nested MoE and MLA configs as dicts of theirs."""
    return dataclasses.asdict(obj)


def test_config_fields_equal():
    for t, j in ((tsd.CONFIG, jsd.CONFIG), (tsd.PRODUCTION, jsd.PRODUCTION),
                 (tbase.UNetConfig().reduced(), jbase.UNetConfig().reduced())):
        assert _fields(t) == _fields(j)
    assert tbase.UNetConfig.source == jbase.UNetConfig.source
    kw = dict(name="m", family="encoder", num_layers=6, d_model=512, num_heads=8,
              num_kv_heads=8, d_ff=2048, vocab_size=4096, is_encoder=True)
    t, j = tbase.ModelConfig(**kw), jbase.ModelConfig(**kw)
    assert _fields(t) == _fields(j)
    assert _fields(t.reduced()) == _fields(j.reduced())
    assert (t.resolved_head_dim, t.blocks) == (j.resolved_head_dim, j.blocks)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-14b", "yi-9b", "h2o-danube-3-4b",
                                  "mixtral-8x7b", "deepseek-v2-lite-16b", "recurrentgemma-9b",
                                  "xlstm-350m", "hubert-xlarge", "chameleon-34b"])
def test_decoder_config_copies_equal(arch):
    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg
    t, j = treg.get_config(arch), jreg.get_config(arch)
    assert _fields(t) == _fields(j)
    assert _fields(treg.get_smoke_config(arch)) == _fields(jreg.get_smoke_config(arch))
    assert (t.resolved_head_dim, t.blocks) == (j.resolved_head_dim, j.blocks)


def test_registry_copies_every_architecture():
    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg
    assert treg.list_archs() == jreg.list_archs()


def test_prompt_copies_equal():
    from repro.data import prompts as jprompts
    from repro_torch.data import prompts as tprompts
    assert tprompts.PAPER_PROMPTS == jprompts.PAPER_PROMPTS
