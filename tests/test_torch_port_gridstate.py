"""The port's grid-state file format (``diffuman4d_torch/io/gridstate.py``)
against the JAX package's: the same meta and arrays give byte-equal files,
each package reads the other's, a foreign file is refused, and a bf16 grid's
uint16 bits round-trip through a torch tensor and agree with the JAX
package's bitcast."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from diffuman4d_tpu.io import gridstate as jgs
from diffuman4d_torch.io import gridstate as pgs
from diffuman4d_torch.sampling.sampler import _to_host_bits


def _arrays(seed: int = 0) -> tuple[dict, dict]:
    r = np.random.default_rng(seed)
    arrays = {
        "latents": r.integers(0, 2**16, (3, 4, 8, 8, 4), dtype=np.uint16),
        "aux_prev": r.standard_normal((3, 4, 8, 8, 4)).astype(np.float32),
        "t_idx": r.integers(0, 9, (3, 4), dtype=np.int32),
    }
    meta = {"seed": 7, "completed_rounds": 1, "tasks_done_in_round": 2,
            "bf16_bits": ["latents"]}
    return meta, arrays


def test_both_packages_write_byte_equal_files(tmp_path):
    meta, arrays = _arrays()
    pgs.write_state(str(tmp_path / "port.d4d"), meta, arrays)
    jgs.write_state(str(tmp_path / "jax.d4d"), meta, arrays)
    assert (tmp_path / "port.d4d").read_bytes() == (tmp_path / "jax.d4d").read_bytes()
    assert not (tmp_path / "port.d4d.tmp").exists()  # written to .tmp, then replaced


@pytest.mark.parametrize("mmap", [True, False], ids=["mmap", "read"])
@pytest.mark.parametrize("writer,reader", [(jgs, pgs), (pgs, jgs), (pgs, pgs)],
                         ids=["jax_to_port", "port_to_jax", "port_to_port"])
def test_each_package_reads_the_others_file(tmp_path, writer, reader, mmap):
    meta, arrays = _arrays(1)
    path = str(tmp_path / "s.d4d")
    writer.write_state(path, meta, arrays)
    got_meta, got = reader.read_state(path, mmap=mmap)
    assert got_meta == meta and list(got) == list(arrays)
    for name, want in arrays.items():
        assert got[name].dtype == want.dtype and got[name].shape == np.shape(want)
        np.testing.assert_array_equal(np.asarray(got[name]), want)


def test_foreign_file_is_refused(tmp_path):
    path = tmp_path / "x.bin"
    path.write_bytes(b"NOTASTATE" * 4)
    with pytest.raises(ValueError, match="D4DGRID1"):
        pgs.read_state(str(path))


def test_bf16_bits_round_trip_through_a_torch_tensor(tmp_path):
    """``save_state``'s wire format: a bf16 tensor -> uint16 bits -> file ->
    bf16 tensor, bit for bit; the bits are the JAX package's bitcast of the
    same bf16 values."""
    import jax
    import jax.numpy as jnp

    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 5, 3), np.float32))
    x = torch.cat([x, torch.tensor([[[float("inf"), -0.0, 1e-40]] * 5])]).to(torch.bfloat16)
    bits = _to_host_bits(x)
    assert bits.dtype == np.uint16 and bits.shape == tuple(x.shape)
    jbits = np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.uint16))
    np.testing.assert_array_equal(bits, jbits)
    path = str(tmp_path / "b.d4d")
    pgs.write_state(path, {"bf16_bits": ["x"]}, {"x": bits})
    _, data = pgs.read_state(path)
    back = torch.from_numpy(np.array(data["x"]).view(np.int16)).view(torch.bfloat16)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    # an fp32 grid is written as it is
    y = torch.randn(3, 2)
    assert _to_host_bits(y).dtype == np.float32
    np.testing.assert_array_equal(_to_host_bits(y), y.numpy())
