"""The port's serving engine against the JAX package's, on the same
params and requests: greedy token lists and ``stats`` identical, and the
cases of tests/test_serving.py held against both engines, on a dense
model, mamba2-130m's smoke config, a hybrid (attention + Mamba) and the
MoE smoke configs of qwen3-moe-30b-a3b and jamba-1.5-large-398b."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.configs.mamba2_130m import smoke as jmamba  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServe  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.configs.mamba2_130m import smoke as tmamba  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import model_kernels  # noqa: E402
from repro_torch.models import apply_model  # noqa: E402
from repro_torch.serving import Request as TRequest  # noqa: E402
from repro_torch.serving import ServeConfig as TServe  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402

DENSE = dict(name="d", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=211, q_block=8)
# tests/test_serving.py::test_hybrid_serving_greedy's config
HYBRID = dict(name="h", family="hybrid", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab=97, attn_layer_period=4,
              attn_layer_offset=1, ssm_state=16, ssm_head_dim=16,
              ssm_chunk=8, q_block=8)
SSM_SERVE = dict(n_slots=2, max_seq=32, max_new_tokens=4)


@pytest.fixture(scope="module")
def dense_setup():
    jcfg = JConfig(dtype=jnp.float32, param_dtype=jnp.float32, **DENSE)
    tcfg = TConfig(dtype=torch.float32, param_dtype=torch.float32, **DENSE)
    jp, _ = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _serve(setup, prompts, scfg_kw, req_kw=None, **engine_kw):
    """Run the same requests through both engines; returns
    (jax engine, jax finished, port engine, port finished)."""
    jcfg, tcfg, jp, tp = setup
    req_kw = req_kw or [{}] * len(prompts)
    je = JEngine(jcfg, jp, JServe(**scfg_kw),
                 use_executor=engine_kw.get("use_executor", True))
    te = TEngine(tcfg, tp, TServe(**scfg_kw), device="cpu", **engine_kw)
    for i, (p, kw) in enumerate(zip(prompts, req_kw)):
        je.submit(JRequest(rid=i, prompt=p, **kw))
        te.submit(TRequest(rid=i, prompt=p, **kw))
    return je, je.run_until_drained(), te, te.run_until_drained()


def _same(jdone, tdone):
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert [r.error is None for r in tdone] == [r.error is None
                                                for r in jdone]


@pytest.mark.parametrize("use_executor", [True, False])
def test_greedy_tokens_and_stats_identical(dense_setup, use_executor):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 211, 4 + 3 * i).astype(np.int32)
               for i in range(7)]
    je, jd, te, td = _serve(dense_setup, prompts,
                            dict(n_slots=3, max_seq=64, max_new_tokens=6),
                            use_executor=use_executor)
    _same(jd, td)
    assert te.stats == je.stats


def test_flash_hook_engine_matches_reference(dense_setup):
    """With the port's kernels (plain flash on CPU) the engine still
    gives the reference engine's tokens."""
    _, tcfg, _, _ = dense_setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 211, n).astype(np.int32) for n in (13, 9, 29)]
    je, jd, te, td = _serve(dense_setup, prompts,
                            dict(n_slots=2, max_seq=64, max_new_tokens=5),
                            kernels=model_kernels(tcfg))
    _same(jd, td)
    assert te.stats == je.stats


@pytest.fixture(scope="module")
def windowed_setup():
    """qwen2-0.5b's smoke config with an 8-row sliding window on both
    sides, the reference's params loaded into the port."""
    import dataclasses
    from repro.configs.qwen2_0_5b import smoke as jqwen2
    from repro_torch.configs.qwen2_0_5b import smoke as tqwen2
    jcfg = dataclasses.replace(jqwen2(), sliding_window=8)
    tcfg = dataclasses.replace(tqwen2(), sliding_window=8)
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(3))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_model_kernels_of_windowed_config_has_no_flash_hook(windowed_setup):
    """The flash kernel applies no window, so a windowed config gets no
    flash hook; the SSD and grouped-matmul hooks stay."""
    _, tcfg, _, _ = windowed_setup
    hooks = model_kernels(tcfg)
    assert "flash_attention" not in hooks
    assert {"ssd_scan", "moe_gmm"} <= set(hooks)
    assert "flash_attention" in model_kernels(
        TConfig(dtype=torch.float32, param_dtype=torch.float32, **DENSE))


@pytest.mark.parametrize("plen", [11, 21])
def test_windowed_prefill_with_kernels_matches_reference(windowed_setup,
                                                         plen):
    """A prompt longer than the window: the port's prefill with
    ``model_kernels(cfg)`` (as its serve path builds the engine) gives
    the reference's prefill logits, which it computes with no kernels
    (as ``repro.launch.serve`` builds its engine), and the same greedy
    tokens through both engines.  21 rows exceed ``q_block`` (16), so
    the chunked attention runs too."""
    from repro.models import init_cache as jcache
    from repro.models import prefill as jprefill
    from repro_torch.models import init_cache as tcache
    from repro_torch.models import prefill as tprefill
    jcfg, tcfg, jp, tp = windowed_setup
    prompt = np.random.default_rng(plen).integers(
        0, jcfg.vocab, plen).astype(np.int32)
    want, _ = jprefill(jcfg, jp, jnp.asarray(prompt)[None],
                       jcache(jcfg, 1, 32))
    got, _ = tprefill(tcfg, tp, torch.as_tensor(prompt)[None],
                      tcache(tcfg, 1, 32, device="cpu"),
                      kernels=model_kernels(tcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    scfg = dict(n_slots=1, max_seq=32, max_new_tokens=5)
    je = JEngine(jcfg, jp, JServe(**scfg))
    te = TEngine(tcfg, tp, TServe(**scfg), device="cpu",
                 kernels=model_kernels(tcfg))
    je.submit(JRequest(rid=0, prompt=prompt))
    te.submit(TRequest(rid=0, prompt=prompt))
    _same(je.run_until_drained(), te.run_until_drained())


def test_continuous_batching_drains(dense_setup):
    prompts = [np.arange(4 + i % 3, dtype=np.int32) for i in range(7)]
    je, jd, te, td = _serve(dense_setup, prompts,
                            dict(n_slots=3, max_seq=64, max_new_tokens=6))
    assert len(td) == 7
    assert all(len(r.output) == 6 for r in td)
    assert te.stats["prefills"] == 7
    assert te.stats["ticks"] >= 2
    _same(jd, td)
    assert te.stats == je.stats


def test_greedy_matches_full_forward(dense_setup):
    _, tcfg, _, tp = dense_setup
    je, jd, te, td = _serve(dense_setup, [np.arange(7, dtype=np.int32)],
                            dict(n_slots=2, max_seq=64, max_new_tokens=5))
    r = td[0]
    toks = list(r.prompt)
    for _ in range(len(r.output)):
        lg = apply_model(tcfg, tp, torch.as_tensor(toks)[None])[0]
        toks.append(int(torch.argmax(lg[0, -1])))
    assert toks[len(r.prompt):] == r.output
    _same(jd, td)


def test_eos_terminates(dense_setup):
    prompt = np.arange(5, dtype=np.int32)
    _, jd0, _, td0 = _serve(dense_setup, [prompt],
                            dict(n_slots=1, max_seq=64, max_new_tokens=3))
    first = td0[0].output[0]
    assert jd0[0].output[0] == first
    je, jd, te, td = _serve(dense_setup, [prompt],
                            dict(n_slots=1, max_seq=64, max_new_tokens=50,
                                 eos_token=first))
    assert td[0].output == [first]
    _same(jd, td)
    assert te.stats == je.stats


def test_per_request_max_new(dense_setup):
    je, jd, te, td = _serve(dense_setup, [np.arange(4, dtype=np.int32)],
                            dict(n_slots=2, max_seq=64, max_new_tokens=10),
                            req_kw=[dict(max_new_tokens=2)])
    assert len(td[0].output) == 2
    _same(jd, td)
    assert te.stats == je.stats


def test_oversized_prompt_rejected(dense_setup):
    je, jd, te, td = _serve(dense_setup, [np.arange(20, dtype=np.int32)],
                            dict(n_slots=1, max_seq=16))
    assert td[0].done and td[0].output == [] and td[0].error
    assert te.failed == [td[0]]
    _same(jd, td)
    assert te.stats == je.stats


def test_temperature_sampling_varies(dense_setup):
    """Distributions are not compared (the generators differ); the
    port's samples vary with the seed, and repeat for one seed."""
    _, tcfg, _, tp = dense_setup
    outs = []
    for seed in (0, 1, 2, 0):
        eng = TEngine(tcfg, tp, TServe(n_slots=1, max_seq=64,
                                       max_new_tokens=8, temperature=1.5,
                                       seed=seed), device="cpu")
        eng.submit(TRequest(rid=0, prompt=np.arange(5, dtype=np.int32)))
        outs.append(tuple(eng.run_until_drained()[0].output))
    assert len(set(outs)) > 1
    assert outs[0] == outs[3]


def test_failover_waits_for_fault_port(dense_setup):
    """``runtime/fault.py`` is ported: ``failover=True`` attaches a default
    failover heartbeat and a warm standby on the serving device's axis,
    and a given ``heartbeat`` is attached as it is (the engine's failover
    run is in tests/test_torch_fault.py)."""
    from repro_torch.runtime import HeartbeatMonitor
    _, tcfg, _, tp = dense_setup
    eng = TEngine(tcfg, tp, TServe(), failover=True, device="cpu")
    assert isinstance(eng.heartbeat, HeartbeatMonitor)
    assert eng.heartbeat.on_dead == "failover"
    assert eng.lcx_runtime.heartbeat is eng.heartbeat
    assert eng.standby_device.alive
    assert eng.standby_device.axis == eng._executor.device.axis
    hb = HeartbeatMonitor(on_dead="drain")
    eng = TEngine(tcfg, tp, TServe(), heartbeat=hb, device="cpu")
    assert eng.heartbeat is hb and eng.lcx_runtime.heartbeat is hb
    assert TEngine(tcfg, tp, TServe(), device="cpu").heartbeat is None


def test_engine_runs_ticks_as_executor_tasks(dense_setup):
    """Admission and decode are tasks of the engine's AMT executor, on
    a private LCX runtime."""
    prompts = [np.arange(3 + i, dtype=np.int32) for i in range(3)]
    _, _, te, td = _serve(dense_setup, prompts,
                          dict(n_slots=2, max_seq=32, max_new_tokens=3))
    tasks = list(te._executor.graph.tasks.values())
    assert {t.name for t in tasks if t.name.startswith("prefill:")} == \
        {"prefill:0", "prefill:1", "prefill:2"}
    assert sum(t.name == "decode" for t in tasks) >= te.stats["ticks"]
    assert all(t.done for t in tasks)
    assert te.lcx_runtime.name == "serving"
    assert te._executor.runtime is te.lcx_runtime


@pytest.fixture(scope="module", params=["mamba2", "hybrid"])
def ssm_setup(request):
    if request.param == "mamba2":
        jcfg, tcfg = jmamba(), tmamba()
    else:
        jcfg = JConfig(dtype=jnp.float32, param_dtype=jnp.float32, **HYBRID)
        tcfg = TConfig(dtype=torch.float32, param_dtype=torch.float32,
                       **HYBRID)
    # the reference's init compiled as one program: twice as fast as op
    # by op
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def ssm_reference(ssm_setup):
    """Four requests on two slots through the reference engine: the
    two-token prompts (shorter than the conv window) reuse the slots the
    nine-token ones left, so a prefill must overwrite the whole state a
    longer earlier prompt left."""
    jcfg, _, jp, _ = ssm_setup
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (9, 9, 2, 2)]
    je = JEngine(jcfg, jp, JServe(**SSM_SERVE))
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p))
    return prompts, je.run_until_drained(), je.stats


@pytest.mark.parametrize("kernels", [False, True])
def test_ssm_engine_matches_reference(ssm_setup, ssm_reference, kernels):
    """The port's engine gives the reference engine's tokens and stats,
    with the port's kernels (plain versions on the CPU) or without."""
    _, tcfg, _, tp = ssm_setup
    prompts, jd, jstats = ssm_reference
    te = TEngine(tcfg, tp, TServe(**SSM_SERVE), device="cpu",
                 kernels=model_kernels(tcfg) if kernels else None)
    for i, p in enumerate(prompts):
        te.submit(TRequest(rid=i, prompt=p))
    _same(jd, te.run_until_drained())
    assert te.stats == jstats
    assert te.stats["prefills"] == 4 and not te.failed


def test_ssm_greedy_matches_full_forward(ssm_setup):
    """tests/test_serving.py::test_hybrid_serving_greedy on the port: the
    engine's greedy tokens equal token-by-token apply_model."""
    _, tcfg, _, tp = ssm_setup
    eng = TEngine(tcfg, tp, TServe(n_slots=2, max_seq=64, max_new_tokens=4),
                  device="cpu")
    eng.submit(TRequest(rid=0, prompt=np.arange(6, dtype=np.int32)))
    r = eng.run_until_drained()[0]
    toks = list(r.prompt)
    for _ in range(len(r.output)):
        lg = apply_model(tcfg, tp, torch.as_tensor(toks)[None])[0]
        toks.append(int(torch.argmax(lg[0, -1])))
    assert toks[len(r.prompt):] == r.output


# ---------------------------------------------------------------------------
# MoE serving.  The reference vmaps decode over the slots, so each slot's
# token is routed alone (T = 1, capacity 8); the port decodes all slots in
# one batch with models.moe.decode_capacity(n_slots) >= n_slots, so no
# expert drops a decode token on either side, whatever the slot count.
# ---------------------------------------------------------------------------
from repro.configs.jamba_1_5_large_398b import smoke as jjamba  # noqa: E402
from repro.configs.qwen3_moe_30b_a3b import smoke as jqwen3  # noqa: E402
from repro_torch.configs.jamba_1_5_large_398b import smoke as tjamba  # noqa: E402
from repro_torch.configs.qwen3_moe_30b_a3b import smoke as tqwen3  # noqa: E402

MOE_SERVE = dict(n_slots=3, max_seq=32, max_new_tokens=5)


@pytest.fixture(scope="module", params=["qwen3-moe", "jamba"])
def moe_setup(request):
    jcfg, tcfg = {"qwen3-moe": (jqwen3, tqwen3),
                  "jamba": (jjamba, tjamba)}[request.param]
    jcfg, tcfg = jcfg(), tcfg()
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(5))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (7, 12, 7, 12, 7)]
    je = JEngine(jcfg, jp, JServe(**MOE_SERVE))
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p))
    return tcfg, tp, prompts, je.run_until_drained(), je.stats


@pytest.mark.parametrize("kernels", [False, True])
def test_moe_engine_matches_reference(moe_setup, kernels):
    """Five requests on three slots: the port's engine gives the reference
    engine's greedy tokens and stats, with the port's kernels (the
    grouped matmul's plain version on the CPU) or without."""
    tcfg, tp, prompts, jd, jstats = moe_setup
    te = TEngine(tcfg, tp, TServe(**MOE_SERVE), device="cpu",
                 kernels=model_kernels(tcfg) if kernels else None)
    for i, p in enumerate(prompts):
        te.submit(TRequest(rid=i, prompt=p))
    _same(jd, te.run_until_drained())
    assert te.stats == jstats
    assert te.stats["prefills"] == len(prompts) and not te.failed


def test_moe_engine_with_more_slots_than_capacity_matches_reference(
        monkeypatch):
    """qwen3-moe's smoke config at capacity factor 1.0 on 16 slots, ten
    of which hold the same prompt: in decode one expert is chosen by more
    slots than capacity(16) = 8, which the reference (each slot routed
    alone) keeps; the port's batched decode must keep them too."""
    import dataclasses
    from repro_torch.models import moe as tm

    jcfg = dataclasses.replace(jqwen3(), capacity_factor=1.0)
    tcfg = dataclasses.replace(tqwen3(), capacity_factor=1.0)
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(5))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(8)
    same = rng.integers(0, jcfg.vocab, 9).astype(np.int32)
    prompts = [same] * 10 + [rng.integers(0, jcfg.vocab, 9).astype(np.int32)
                             for _ in range(6)]
    scfg = dict(n_slots=16, max_seq=32, max_new_tokens=4)
    je = JEngine(jcfg, jp, JServe(**scfg))
    te = TEngine(tcfg, tp, TServe(**scfg), device="cpu")
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p))
        te.submit(TRequest(rid=i, prompt=p))
    jd = je.run_until_drained()

    # the precondition, read from the router on each decode tick's hidden
    # states: some expert is chosen by more slots than capacity(n_slots)
    most = []
    route = tm.route

    def spy(cfg, router_p, x):
        out = route(cfg, router_p, x)
        if x.shape[0] == scfg["n_slots"]:
            most.append(int(torch.bincount(
                out[0].reshape(-1), minlength=cfg.n_experts).max()))
        return out

    monkeypatch.setattr(tm, "route", spy)
    td = te.run_until_drained()
    assert most and max(most) > tm.capacity(tcfg, scfg["n_slots"])
    _same(jd, td)
    assert te.stats == je.stats


# ---------------------------------------------------------------------------
# The architectures of the last slice: DeepSeek-V3 (MLA layers with the
# absorbed decode against the latent cache, a dense prefix layer, MoE with
# a sigmoid router and a shared expert) and starcoder2-7b (layernorm,
# GELU, QKV bias, a 16-row sliding window that the prompts cross); and
# launch/serve.py's refusal of the encoder-only audio architecture.
# ---------------------------------------------------------------------------
from repro.configs.deepseek_v3_671b import smoke as jdeepseek  # noqa: E402
from repro.configs.starcoder2_7b import smoke as jstarcoder  # noqa: E402
from repro_torch.configs.deepseek_v3_671b import smoke as tdeepseek  # noqa: E402
from repro_torch.configs.starcoder2_7b import smoke as tstarcoder  # noqa: E402

ARCH_SERVE = dict(n_slots=3, max_seq=48, max_new_tokens=6)


@pytest.mark.parametrize("arch", ["deepseek-v3", "starcoder2"])
def test_new_arch_engine_matches_reference(arch):
    """Five requests on three slots, prompts of 9 and 21 tokens (21 + 6
    rows cross starcoder2's window of 16): the port's engine, with the
    port's kernels as its serve path builds it, gives the reference
    engine's greedy tokens and stats."""
    jcfg, tcfg = {"deepseek-v3": (jdeepseek, tdeepseek),
                  "starcoder2": (jstarcoder, tstarcoder)}[arch]
    jcfg, tcfg = jcfg(), tcfg()
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(7))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (9, 21, 9, 21, 9)]
    je = JEngine(jcfg, jp, JServe(**ARCH_SERVE))
    te = TEngine(tcfg, tp, TServe(**ARCH_SERVE), device="cpu",
                 kernels=model_kernels(tcfg))
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p))
        te.submit(TRequest(rid=i, prompt=p))
    _same(je.run_until_drained(), te.run_until_drained())
    assert te.stats == je.stats and not te.failed


def test_serve_cli_refuses_audio():
    """``launch/serve.py --arch hubert-xlarge`` exits with the reference's
    message, on the CPU too: an encoder has no decode path."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", "hubert-xlarge", "--device", "cpu"],
                       env=dict(os.environ, PYTHONPATH=str(src)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "encoder-only architectures have no decode path" in r.stderr
