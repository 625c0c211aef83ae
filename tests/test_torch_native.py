"""The port's native host data plane (``any4_tpu_torch/native``) against the
port's torch functions, bit for bit: the cases of ``tests/test_native.py``,
in the port's Hopper layout (``ops.packing.pack_codes``) where the JAX
package packs its planar one. The library is built with the machine's C++
compiler into ``any4_tpu_torch/_build/`` at first use.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from any4_tpu.ops import linear as jlin
from any4_tpu_torch import convert, native
from any4_tpu_torch.ops import linear as lin
from any4_tpu_torch.ops import packing, quant


@pytest.fixture(scope="module", autouse=True)
def built():
    if native.compiler() is None:
        pytest.skip("no C++ compiler on this machine")
    assert native.available()


class TestNativePack:
    @pytest.mark.parametrize("k,shards", [(2048, 1), (1536, 1), (4096, 4),
                                          (2560, 2), (1000, 1)])
    def test_matches_torch_pack(self, k, shards):
        codes = np.random.RandomState(0).randint(0, 16, (16, k)).astype(
            np.uint8)
        got = native.pack_int4(codes, shards)
        want = packing.pack_codes(torch.from_numpy(codes), shards).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(native.unpack_int4(got, k, shards),
                                      codes)

    def test_roundtrip(self):
        codes = np.random.RandomState(1).randint(0, 16, (8, 11008)).astype(
            np.uint8)
        packed = native.pack_int4(codes)
        np.testing.assert_array_equal(native.unpack_int4(packed, 11008),
                                      codes)
        np.testing.assert_array_equal(
            packing.unpack_codes(torch.from_numpy(packed), 11008).numpy(),
            codes)

    def test_refuses_bad_shapes(self):
        with pytest.raises(ValueError, match="shards"):
            native.pack_int4(np.zeros((2, 10), np.uint8), 3)
        with pytest.raises(ValueError, match="does not hold"):
            native.unpack_int4(np.zeros((2, 8), np.int32), 1024, 2)


class TestNativeQuantize:
    @pytest.mark.parametrize("bits,g,shape", [(4, 128, (32, 1024)),
                                              (8, 64, (8, 256)),
                                              (4, 32, (5, 96))])
    def test_matches_torch_group_quantize(self, bits, g, shape):
        w = np.random.RandomState(2).randn(*shape).astype(np.float32)
        c0, s0, z0 = native.group_quantize(w, bits, g)
        c1, s1, z1 = quant.group_quantize(torch.from_numpy(w), bits, g)
        np.testing.assert_array_equal(c0, c1.numpy())
        np.testing.assert_allclose(s0, s1.numpy(), rtol=1e-6)
        np.testing.assert_allclose(z0, z1.numpy(), rtol=1e-6)
        # the same operations in the same order: the same bits
        np.testing.assert_array_equal(s0, s1.numpy())
        np.testing.assert_array_equal(z0, z1.numpy())


class TestNativeQuantizePath:
    def test_numpy_input_uses_native_and_matches(self, monkeypatch):
        """``quantize_tensor`` on a host numpy array goes through the C++
        data plane and gives the torch path's packed codes, scales and
        zeros, and, carried to the JAX layout, the JAX package's own
        host-path weight."""
        calls = []
        real = native.group_quantize
        monkeypatch.setattr(native, "group_quantize",
                            lambda *a: calls.append(a) or real(*a))
        w = np.random.RandomState(5).randn(64, 1536).astype(np.float32)
        host = lin.quantize_tensor(w, "int4", group_size=128, row_shards=2)
        dev = lin.quantize_tensor(torch.from_numpy(w), "int4",
                                  group_size=128, row_shards=2)
        assert len(calls) == 1
        assert host.fmt == dev.fmt == "int4p" and host.row_shards == 2
        for f in ("packed", "scales", "zeros"):
            assert torch.equal(getattr(host, f), getattr(dev, f)), f
        jq = jlin.quantize_tensor(w, "int4", group_size=128, row_shards=2)
        back = convert.qt_to_jax(host)
        np.testing.assert_array_equal(back["packed"], np.asarray(jq.packed))
        np.testing.assert_allclose(back["scales"], np.asarray(jq.scales),
                                   rtol=1e-6)

    def test_numpy_input_other_formats_take_torch(self, monkeypatch):
        monkeypatch.setattr(native, "group_quantize", None)
        w = np.random.RandomState(6).randn(16, 256).astype(np.float32)
        host = lin.quantize_tensor(w, "int4", group_size=128,
                                   scale_only=True)
        dev = lin.quantize_tensor(torch.from_numpy(w), "int4",
                                  group_size=128, scale_only=True)
        assert torch.equal(host.packed, dev.packed)


class TestNativeLutAssign:
    def test_matches_argmin(self):
        rng = np.random.RandomState(4)
        wg = (rng.rand(8, 512) * 15).astype(np.float32)
        lut = np.sort(rng.rand(8, 16) * 15, axis=1).astype(np.float32)
        d = torch.from_numpy(np.abs(wg[:, :, None] - lut[:, None, :]))
        np.testing.assert_array_equal(native.lut_assign(wg, lut),
                                      torch.argmin(d, dim=2).numpy())


class TestBf16:
    def test_widening(self):
        vals = torch.tensor([1.0, -2.5, 0.0, 3.14159, 1e-30, -7e20])
        bf = vals.to(torch.bfloat16)
        raw = bf.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(native.bf16_to_f32(raw),
                                      bf.float().numpy())
        jax_raw = np.asarray(jnp.asarray(vals.numpy()).astype(jnp.bfloat16))
        np.testing.assert_array_equal(native.bf16_to_f32(jax_raw),
                                      bf.float().numpy())


class TestAvailability:
    def test_no_compiler_is_unavailable(self, monkeypatch):
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "compiler", lambda: None)
        assert native.available() is False
        assert native.num_threads() == 0
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            native.pack_int4(np.zeros((1, 8), np.uint8))

    def test_failing_compiler_raises(self, monkeypatch, tmp_path):
        """A compiler that is found but fails to build raises; nothing
        falls back to torch quietly."""
        bad = tmp_path / "cc"
        bad.write_text("#!/bin/sh\necho broken >&2\nexit 1\n")
        bad.chmod(0o755)
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "compiler", lambda: str(bad))
        with pytest.raises(RuntimeError, match="failed to build"):
            native.available()


def test_quantize_script_takes_the_host_path(tmp_path, capsys):
    """``cli.quantize --fmt int4 --tiny`` reports the data plane on, packs
    the weights on the host, and its codes are the device path's (the torch
    quantizer on the same seeded model)."""
    from any4_tpu_torch.cli import quantize
    from any4_tpu_torch.models import llama
    from any4_tpu_torch.quant import api

    host, cfg = quantize.main(["--cpu", "--tiny", "--fmt", "int4",
                               "--output", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"native data plane: on ({native.num_threads()} threads)" in out
    assert "quantizing host-side" in out
    dev = api.quantize_model(llama.init_params(cfg, seed=0, device="cpu"),
                             fmt="int4", device="cpu")
    for i, layer in enumerate(dev["layers"]):
        for name, qt in layer.items():
            if isinstance(qt, lin.QuantizedTensor):
                got = host["layers"][i][name]
                assert got.fmt == qt.fmt, name
                for f in ("packed", "scales", "zeros"):
                    assert torch.equal(getattr(got, f), getattr(qt, f)), f
