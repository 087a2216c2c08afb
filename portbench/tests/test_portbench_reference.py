"""The benchmark's fp32 reference against the program's eager CPU path, its
NF4 decoding against a hand-worked byte, and its fp8 control against the
check's limit, at tiny sizes."""

import ast

import numpy as np
import pytest
import torch
from conftest import CLOSED, CONTROL_LIMITS, OPEN, PORTBENCH, TINY_MIXTRAL, TINY_QWEN2, StepClock, committed_limits

from portbench import harness, port, reference
from portbench.model import from_config
from portbench.traffic import Traffic
from portbench.weights import Head, Layer

SHAPES = {"qwen2": TINY_QWEN2, "mixtral": TINY_MIXTRAL}


def _engine(model, seed, device="cpu"):
    layers = [Layer(model, device).fill(seed, i) for i in range(model.layers)]
    head = Head(model, device).fill(seed)
    return port.engine(model, port.params(model, layers, head), 4, device)


def test_dequant_hand_worked_byte():
    """Byte 0x2F at K rows 0 and 1 of column 0: the low nibble (15) is K row 0,
    code +1.0; the high nibble (2) is K row 1, code -0.5250730514526367; the
    block's scale 0.5 multiplies both."""
    packed = torch.zeros((512, 128), dtype=torch.uint8)
    packed[0, 0] = 0x2F
    scales = torch.zeros((16, 128))
    scales[0, 0] = 0.5
    wt = reference.dequant_t(packed, scales, 1024, 128)
    assert wt[0, 0].item() == 0.5
    assert wt[1, 0].item() == np.float32(-0.5250730514526367 * 0.5)
    assert (wt[2:64, 0] == -0.5).all()  # byte 0: code index 0 is -1.0, in the same block of 64
    assert (wt[64:, 0] == 0.0).all() and (wt[:, 1:] == 0.0).all()  # scale 0
    assert reference.NF4_VALUES[7] == 0.0 and len(reference.NF4_VALUES) == 16


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_reference_against_engine_generate(shape):
    """Prefill then decode through the cache (Engine.generate, greedy) serves
    the reference's best token at every position, within the bf16 program's
    rounding; the teacher-forced log-probabilities (Engine.score) agree with
    the reference's at every position of prompt and answer."""
    model = from_config(shape, SHAPES[shape])
    seed = 2**31 + 77
    eng = _engine(model, seed)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.vocab, n).tolist() for n in (20, 37, 9, 50)]
    results = eng.generate(prompts, max_new_tokens=12)
    seqs = [(p + r.tokens[:-1], len(p) - 1) for p, r in zip(prompts, results)]
    ref = reference.logits(model, seed, seqs, "cpu")["fp32"]
    assert all(len(r.tokens) == 12 for r in results)
    gaps = torch.cat([reference.token_gaps(lg, r.tokens) for lg, r in zip(ref, results)]).numpy()
    # bf16 activations flip a near-tied best token now and then (and an MoE
    # route near a tie); a wrong layer moves most positions' best token.
    assert np.percentile(gaps, 90) == 0.0
    full = [(p + r.tokens, 0) for p, r in zip(prompts, results)]
    ref_full = reference.logits(model, seed, full, "cpu")["fp32"]
    scored = eng.score([p + r.tokens for p, r in zip(prompts, results)])
    diffs = []
    for lg, (toks, _), lp in zip(ref_full, full, scored):
        want = torch.log_softmax(lg[:-1], dim=-1).gather(-1, torch.tensor(toks[1:])[:, None])[:, 0]
        diffs.append(np.abs(np.asarray(lp) - want.numpy()))
    diffs = np.concatenate(diffs)
    # The program's bf16 residual stream against fp32, in nats, at log-probs of
    # ~6: a median of ~0.009 and a 90th percentile of 0.02-0.03 at these seeds.
    assert np.median(diffs) <= 0.02 and np.percentile(diffs, 90) <= 0.05


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fp8_control_fails_the_limit(shape):
    """The control (the reference with every projection's operands in float8
    e4m3), sampled as a committed cell samples, comes out not correct by the
    harness's own checks on each of three seeds, where the program passes."""
    model = from_config(shape, SHAPES[shape])
    cell = "tiny-qwen2.chat" if shape == "qwen2" else "tiny-qwen2.batch"
    limits = dict(committed_limits(cell), limits=CONTROL_LIMITS[shape])
    traffic_spec = OPEN if shape == "qwen2" else CLOSED
    program = None
    for seed in (11, 12, 13):
        traffic = Traffic(traffic_spec, model.vocab, seed, 5.0)
        if program is None:
            program = harness.Program(model, traffic, seed, "cpu", traffic.slots)
        else:
            program.fill(seed)
        clock = StepClock()
        win = harness.Window(program, traffic, 5.0, False, clock, clock.sleep).run()
        read = harness.readings(win, harness.sample(win, seed, limits), model, seed, "cpu", control=True)
        assert harness.passed(harness.checks(read["program"], win.failed(), limits))
        assert not harness.passed(harness.checks(read["control"], 0, limits))
        assert read["control"]["checked_slots"] >= limits["min_requests"]


def test_reference_imports_nothing_of_the_program():
    """The reference and what it reads (weights, model, traffic, work) import
    neither the program nor the JAX package."""
    for name in ("reference", "weights", "model", "traffic", "work"):
        tree = ast.parse((PORTBENCH / f"{name}.py").read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("nf4_tpu_torch", "nf4_tpu", "jax", "flax"), (name, m)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_reference_against_engine_generate_on_the_card(shape):
    """On the card (kernels B and C, graphed decode), greedy generation serves
    the reference's best token at every position, the reference computed on
    the card with TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    model = from_config(shape, SHAPES[shape])
    seed = 2**31 + 78
    eng = _engine(model, seed, "cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, model.vocab, n).tolist() for n in (20, 37, 9, 50)]
    results = eng.generate(prompts, max_new_tokens=24)
    seqs = [(p + r.tokens[:-1], len(p) - 1) for p, r in zip(prompts, results)]
    gaps = torch.cat([reference.token_gaps(lg, r.tokens)
                      for lg, r in zip(reference.logits(model, seed, seqs, "cuda")["fp32"], results)])
    assert np.percentile(gaps.cpu().numpy(), 90) == 0.0
