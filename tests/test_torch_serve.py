"""The PyTorch port's GanServer on the CPU: shapes, the remainder buffer,
the accounting invariant, stream determinism, and agreement with the
generator on the latents the server drew."""

import pytest
import torch

from repro_torch.models.gan import GanConfig, Generator, init_gan
from repro_torch.serve.gan import GanServer

CPU = torch.device("cpu")
CFG = GanConfig("dcgan", channel_scale=1 / 32)


@pytest.fixture(scope="module")
def params():
    g, _ = init_gan(CFG, torch.Generator().manual_seed(0), CPU)
    return g


def _server(params, batch_size=4, seed=0):
    return GanServer(CFG, params, batch_size=batch_size, seed=seed,
                     device="cpu")


def _invariant(s: GanServer) -> bool:
    return (s.samples_served + s.samples_buffered + s.samples_discarded
            == s.batches_served * s.batch_size)


@pytest.mark.parametrize("n", [1, 4, 6, 9])
def test_generate_shapes_and_accounting(params, n):
    s = _server(params)
    img = s.generate(n)
    assert tuple(img.shape) == (n, 64, 64, 3)
    assert img.device == CPU and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all()) and img.abs().max() <= 1.0
    assert s.batches_served == -(-n // 4)
    assert s.samples_served == n and s.samples_discarded == 0
    assert _invariant(s)


def test_remainder_is_served_first_and_unchanged(params):
    whole = _server(params).generate(12)
    s = _server(params)
    parts = [s.generate(n) for n in (3, 2, 5, 2)]
    assert s.samples_buffered == 0 and s.batches_served == 3
    # the chunked stream is the whole stream: tails are carried, not
    # dropped or regenerated
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)
    s.generate(1)
    assert s.samples_buffered == 3 and _invariant(s)


def test_invariant_across_calls(params):
    s = _server(params, batch_size=3)
    for n in (1, 5, 2, 7, 3, 1):
        s.generate(n)
        assert _invariant(s)
    assert s.samples_served == 19 and s.samples_discarded == 0


def test_same_seed_same_stream(params):
    a = _server(params, seed=5).generate(6)
    b = _server(params, seed=5).generate(6)
    c = _server(params, seed=6).generate(6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_output_is_the_generator_on_the_drawn_latents(params):
    s = _server(params)
    img = s.generate(4)
    z = _server(params)._next_latents()      # the same stream, replayed
    with torch.inference_mode():
        ref = Generator(CFG, params, device="cpu")(z)
    torch.testing.assert_close(img, ref, rtol=0, atol=0)


def test_bad_arguments_raise(params):
    with pytest.raises(ValueError, match="batch_size"):
        _server(params, batch_size=0)
    s = _server(params)
    with pytest.raises(ValueError, match="positive"):
        s.generate(0)
    assert "served=0" in repr(s)
