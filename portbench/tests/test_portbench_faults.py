"""A run with its timed path broken underneath comes out not correct,
once for each fault a one-chip serving cell can have (no cell here spans
chips, so no exchange between chips can be left out)."""
import pytest

import portbench_tiny as tiny


def stale_state(eng):
    """Every decode step leaves the pool as it found it: its K/V rows
    never land."""
    inner = eng._decode

    def decode(last, cache):
        saved = (cache.k.clone(), cache.v.clone())
        logits, new = inner(last, cache)
        cache.k.copy_(saved[0])
        cache.v.copy_(saved[1])
        return logits, new

    eng._decode = decode


def half_batch(eng):
    """The decode step's second half of the batch is left out: its rows
    take the mean of the first half's logits."""
    inner = eng._decode

    def decode(last, cache):
        logits, new = inner(last, cache)
        h = logits.shape[0] // 2
        logits[h:] = logits[:h].mean(dim=0)
        return logits, new

    eng._decode = decode


def altered_token(eng):
    """Every token is altered where it is sampled."""
    inner = eng._sample

    def sample(*a, **k):
        return (inner(*a, **k) + 1) % eng.cfg.vocab_size

    eng._sample = sample


@pytest.mark.parametrize("fault", [stale_state, half_batch, altered_token])
@pytest.mark.parametrize("config,traffic", [
    ("mistral7b-qpfree", "batch"), ("mistral7b-qpfree", "chat")])
def test_broken_path_is_not_correct(fault, config, traffic):
    res = tiny.run(config, traffic, 64 if traffic == "chat" else 0,
                   fault=fault)
    assert not res["correct"], res["checks"]
