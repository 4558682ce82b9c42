"""libutils/libaudio small-utility parity."""
import numpy as np
import jax.numpy as jnp


def test_futil_helpers(tmp_path):
    from magphase_jax.utils import (DimProtect, fileparts,
                                    indexes_to_one_zero_vector, ins_pid,
                                    ins_date_time, round_to_int,
                                    read_text_file2, is_mutable)
    assert round_to_int(2.5) == 2          # numpy half-to-even
    assert round_to_int(3.5) == 4
    v = indexes_to_one_zero_vector(np.array([1, 3]), 5)
    np.testing.assert_array_equal(v, [0, 1, 0, 1, 0])
    assert fileparts("/a/b/c.wav") == ["/a/b", "c", ".wav", "/a/b/c"]
    assert "_" in ins_pid("/tmp/x.wav") and ins_pid("/tmp/x.wav").endswith(".wav")
    assert ins_date_time("/tmp/x.wav", "pfx").endswith(".wav")
    assert is_mutable(np.zeros(3)) and not is_mutable(3.0)

    p = tmp_path / "one.scp"
    p.write_text("tok1\n")
    assert list(read_text_file2(str(p), dtype="string")) == ["tok1"]

    a = np.arange(4.0)
    dp = DimProtect(a)
    assert a.shape == (4, 1)
    dp.end(a)
    assert a.shape == (4,)


def test_masks_and_frame_shift():
    from magphase_jax.core.misc_dsp import (gen_mask_simple, mix_by_mask,
                                            frame_shift,
                                            estim_ap_mask_from_ph_data)
    v_voi = np.array([1.0, 0.0, 1.0])
    m = np.asarray(gen_mask_simple(v_voi, 8, 5))
    assert m.shape == (3, 8)
    assert m[:, 5:].sum() == 0 and m[0, 0] == 1 and m[1, 0] == 0

    a = np.ones((3, 8)); b = np.zeros((3, 8))
    np.testing.assert_array_equal(np.asarray(mix_by_mask(a, b, m)), m)

    out = frame_shift(np.array([1.0, 2.0]), 3, 8)
    np.testing.assert_array_equal(out, [0, 0, 0, 1, 2, 0, 0, 0])

    mask = estim_ap_mask_from_ph_data(
        np.random.RandomState(0).rand(6, 100) * 0.05, 4096, 48000, 4500.0)
    mask = np.asarray(mask)
    assert mask.shape == (6, 2049)
    assert np.all((mask >= 0) & (mask <= 1.0 + 1e-6))


def test_bucket_signal_geometric():
    from magphase_jax.utils.padding import SIG_STEP, bucket_signal
    # multiples of SIG_STEP, monotone, <=25% overshoot, log-many variants
    assert bucket_signal(1) == SIG_STEP
    assert bucket_signal(163840) == 163840          # demo-corpus bucket
    prev = 0
    variants = set()
    for n in range(1, 300):
        b = bucket_signal(n * 16384)
        assert b % SIG_STEP == 0 and b >= n * 16384
        assert b <= max(SIG_STEP, int(n * 16384 * 1.25) + SIG_STEP)
        assert b >= prev
        prev = b
        variants.add(b)
    assert len(variants) < 25   # ~90 linear buckets collapse to ~20
