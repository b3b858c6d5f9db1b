"""The port's ``ContinuousBatcher`` against the JAX package's, on
``tests/test_serve_engine.py``'s scenarios: batched equals single-request
decode, a queue that drains through fewer slots, the EOS contract.

Both engines run reduced TinyLlama (2 layers) on the same
``convert.numpy_params`` weights, so their greedy tokens must be equal
(the logits agree to ~1e-5; a near-tie could flip an argmax, and these
seeds have none).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.config import reduced as jreduced
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.models import reduced
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.serve import ContinuousBatcher, Request

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("tinyllama_1_1b"), n_layers=2)
    tree = numpy_params(cfg, 0)
    return (cfg, params_from_numpy(tree, cfg, "cpu"),
            jreduced(jget("tinyllama_1_1b"), n_layers=2),
            jax.tree.map(jnp.asarray, tree))


def _serve(model, reqs, n_slots, max_seq=64):
    """(port outputs, JAX outputs) of the same requests, by uid."""
    cfg, tp, jcfg, jp = model
    eng = ContinuousBatcher(cfg, tp, n_slots=n_slots, max_seq=max_seq,
                            device="cpu")
    jeng = JBatcher(jcfg, jp, n_slots=n_slots, max_seq=max_seq)
    for r in reqs:
        eng.submit(Request(**r))
        jeng.submit(JRequest(**r))
    done, jdone = eng.run(), jeng.run()
    assert eng.pending() == jeng.pending() == 0
    assert eng.steps == jeng.steps
    return ({r.uid: r.output for r in done}, {r.uid: r.output for r in jdone})


def test_batched_equals_single_and_jax(model):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=5).tolist() for _ in range(3)]
    reqs = [dict(uid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    got, want = _serve(model, reqs, n_slots=3)
    assert got == want and len(got) == 3
    for r in reqs:
        single, _ = _serve(model, [r], n_slots=1)
        assert single[r["uid"]] == got[r["uid"]]


def test_queue_drains_like_jax(model):
    rng = np.random.default_rng(1)
    reqs = [dict(uid=i, prompt=rng.integers(0, 512, size=4).tolist(),
                 max_new=4) for i in range(5)]
    got, want = _serve(model, reqs, n_slots=2)
    assert got == want and len(got) == 5
    assert all(len(o) == 4 for o in got.values())


def test_eos_stops_at_first_generated_like_jax(model):
    prompt = [5, 6, 7]
    ref, _ = _serve(model, [dict(uid=0, prompt=prompt, max_new=8)], n_slots=1)
    ref = ref[0]
    for probe in (1, 3, 5):
        eos = ref[probe]
        got, want = _serve(model, [dict(uid=0, prompt=prompt, max_new=8,
                                        eos=eos)], n_slots=1)
        assert got == want
        assert got[0] == ref[:ref.index(eos) + 1]
    # a prompt token never stops a request
    got, want = _serve(model, [dict(uid=0, prompt=prompt, max_new=4,
                                    eos=prompt[1])], n_slots=1)
    assert got == want and len(got[0]) == 4


def test_engine_refuses_params_on_another_device(model):
    cfg, tp, _, _ = model
    meta = dict(tp, embed=tp["embed"].to("meta"))
    with pytest.raises(ValueError, match="params on meta"):
        ContinuousBatcher(cfg, meta, device="cpu")
