"""Golden stream-parity oracle: faithful Python-3 numpy port of the
reference's LIVE pipelines (/root/reference/src/magphase.py + libaudio.py).

This module exists so the test suite can run the reference's *actual math*
(per-frame ragged loops and all) next to the JAX framework and assert the
feature streams and deterministic syntheses agree end-to-end.  It is a test
oracle, NOT framework code: it deliberately preserves the reference's
Python-2 integer-division semantics (written as ``//``), its per-frame
loops, and its quirks (e.g. the off-by-one doubling range in
``sp_mel_unwarp``), each tagged with the reference ``file:line``.

The one piece the reference outsources to a native binary — SPTK ``mcep``
(libaudio.py:575-601) — cannot be built here (no egress).  ``mcep_j0``
below is an INDEPENDENT pure-numpy restatement of SPTK-3.9's ``_mcep.c``
zero-iteration path (the exact flags the reference passes: ``-e 1.0E-8
-j 0 -f 0.0``), with ``freqt_sptk`` transcribing ``_freqt.c``'s literal
sequential recursion.  The framework's ``core/melcep.py`` derives the same
function a different way (a precomputed Psi-power matrix); agreement
between the two is asserted by tests/test_ref_parity.py and is the
strongest SPTK-parity evidence available in this environment.
"""
from __future__ import annotations

import numpy as np
from scipy import signal as sp_signal
from scipy import interpolate as sp_interpolate

MAGIC = -1.0e10  # libaudio.py:17


# ---------------------------------------------------------------------------
# libutils ports

def round_to_int(x):
    """libutils.py:131-133 (np.round = round-half-to-even)."""
    return np.round(x).astype(int)


# ---------------------------------------------------------------------------
# libaudio ports

def shift_to_pm(v_shift):
    """libaudio.py:60-62."""
    return np.cumsum(v_shift)


def pm_to_shift(v_pm):
    """libaudio.py:65-67."""
    return np.diff(np.hstack((0, v_pm)))


def gen_non_symmetric_win(left_len, right_len, win_func, b_norm=False):
    """libaudio.py:70-84."""
    v_left_win = win_func(1 + 2 * left_len)[0:(left_len + 1)]
    v_right_win = np.flipud(win_func(1 + 2 * right_len)[0:(right_len + 1)])
    v_win = np.hstack((v_left_win, v_right_win[1:]))
    if b_norm:
        v_win = v_win / np.sum(v_win)
    return v_win


def gen_centr_win(winlen_l, winlen_r, totlen, win_func=None,
                  b_fill_w_bound_val=False):
    """libaudio.py:90-103."""
    v_win_shrt = gen_non_symmetric_win(winlen_l, winlen_r, win_func)
    win_shrt_len = len(v_win_shrt)
    nx_cntr = np.floor(totlen / 2.0).astype(int)
    nzeros_l = nx_cntr - winlen_l
    v_win = np.zeros(totlen)
    if b_fill_w_bound_val:
        v_win += v_win_shrt[0]
    v_win[nzeros_l:nzeros_l + win_shrt_len] = v_win_shrt
    return v_win


def frm_list_to_matrix(l_frames, v_shift, nFFT):
    """libaudio.py:122-134 (nFFThalf uses Python-2 int division)."""
    nFFThalf = nFFT // 2 + 1
    nfrms = len(v_shift)
    m_frm = np.zeros((nfrms, nFFT))
    for i in range(nfrms):
        rel_shift = nFFThalf - v_shift[i] - 1
        v_frm = l_frames[i]
        right_len = nFFT - (rel_shift + len(v_frm))
        m_frm[i, :] = np.hstack(
            (np.zeros(rel_shift), v_frm, np.zeros(right_len)))
    return m_frm


def hz_to_bin(v_hz, nFFT, fs):
    """libaudio.py:151-152."""
    return v_hz * nFFT / float(fs)


def spectral_crossfade(m_sp_l, m_sp_r, cut_off, bw, fs, freq_scale='hz',
                       win_func=np.hanning):
    """libaudio.py:160-186."""
    nFFThalf = m_sp_l.shape[1]
    nFFT = (nFFThalf - 1) * 2
    bin_l = round_to_int(hz_to_bin(cut_off - bw / 2.0, nFFT, fs))
    bin_r = round_to_int(hz_to_bin(cut_off + bw / 2.0, nFFT, fs))
    bw_bin = bin_r - bin_l
    v_win_shrt = win_func(2 * bw_bin + 1)
    v_win_shrt_l = v_win_shrt[bw_bin:]
    v_win_shrt_r = v_win_shrt[:bw_bin + 1]
    v_win_l = np.hstack((np.ones(bin_l), v_win_shrt_l,
                         np.zeros(nFFThalf - bin_r - 1)))
    v_win_r = np.hstack((np.zeros(bin_l), v_win_shrt_r,
                         np.ones(nFFThalf - bin_r - 1)))
    return m_sp_l * v_win_l[None, :] + m_sp_r * v_win_r[None, :]


def protected_log(m_x):
    """libaudio.py:241-248 (la.log)."""
    with np.errstate(divide='ignore', invalid='ignore'):
        m_y = np.log(m_x)
    m_y[np.isinf(m_y)] = MAGIC
    m_y[np.isnan(m_y)] = MAGIC
    return m_y


def add_hermitian_half(m_data, data_type='mag'):
    """libaudio.py:369-388."""
    if data_type in ('mag', 'magnitude'):
        return np.hstack((m_data, np.fliplr(m_data[:, 1:-1])))
    if data_type == 'phase':
        m_data = m_data.copy()
        m_data[:, 0] = 0
        m_data[:, -1] = 0
        return np.hstack((m_data, -np.fliplr(m_data[:, 1:-1])))
    if data_type == 'zeros':
        nfrms, nFFThalf = m_data.shape
        return np.hstack((m_data, np.zeros((nfrms, nFFThalf - 2))))
    if data_type == 'complex':
        return (add_hermitian_half(m_data.real) +
                add_hermitian_half(m_data.imag, data_type='phase') * 1j)
    raise ValueError(data_type)


def remove_hermitian_half(m_data):
    """libaudio.py:392-399."""
    nFFThalf = int(np.floor(np.size(m_data, 1) / 2)) + 1
    return m_data[:, :nFFThalf].copy()


def rceps(m_data, in_type='log', out_type='compact'):
    """libaudio.py:252-269."""
    ncoeffs = m_data.shape[1]
    if in_type == 'abs':
        m_data = protected_log(m_data)
    m_data = add_hermitian_half(m_data, data_type='magnitude')
    m_rceps = np.fft.ifft(m_data).real
    if out_type == 'compact':
        m_rceps[:, 1:(ncoeffs - 2)] *= 2
        m_rceps = m_rceps[:, :ncoeffs]
    return m_rceps


def rceps_to_min_phase_rceps(m_rceps):
    """libaudio.py:190-197 (doubles bins 1..N/2-1 in place; the trailing
    ``return m_rceps[:nFFThalf]`` row-slices, a reference quirk its only
    caller compensates for by ignoring the extra columns)."""
    nFFThalf = m_rceps.shape[1] // 2 + 1
    m_rceps[:, 1:(nFFThalf - 1)] *= 2
    return m_rceps[:nFFThalf]


def spectral_smoothing_rceps(m_sp_log, nc_total=60, fade_to_total=0.2):
    """libaudio.py:203-238."""
    nc_fade = round_to_int(fade_to_total * nc_total)
    m_sp_log_ext = add_hermitian_half(m_sp_log)
    m_rceps = np.fft.ifft(m_sp_log_ext).real
    m_rceps_minph = rceps_to_min_phase_rceps(m_rceps)
    v_win_shrt = np.hanning(2 * nc_fade + 3)
    v_win_shrt = v_win_shrt[nc_fade + 2:-1]
    m_rceps_minph[:, nc_total:] = 0
    m_rceps_minph[:, nc_total - nc_fade:nc_total] *= v_win_shrt
    nfft = m_rceps.shape[1]
    m_sp_log_sm = np.fft.fft(m_rceps_minph, n=nfft).real
    return remove_hermitian_half(m_sp_log_sm)


def db(m_data, b_inv=False):
    """libaudio.py:635-639."""
    if not b_inv:
        return 20 * np.log10(m_data)
    return 10 ** (m_data / 20)


def true_envelope(m_sp, in_type='abs', ncoeffs=60, thres_db=0.1):
    """libaudio.py:295-340 (per-frame iterative max(spec, smoothed),
    max 100 iterations, mean-|diff| early exit)."""
    if in_type == 'db':
        m_sp_db = m_sp
    elif in_type == 'abs':
        m_sp_db = db(m_sp)
    elif in_type == 'log':
        m_sp_db = (20.0 / np.log(10.0)) * m_sp
    m_sp_db_env = np.zeros(m_sp_db.shape)
    nFrms = m_sp_db.shape[0]
    n_maxiter = 100
    for f in range(nFrms):
        v_sp_db = m_sp_db[f, :]
        for _ in range(n_maxiter):
            v_sp_db_sm = spectral_smoothing_rceps(
                v_sp_db[None, :], nc_total=ncoeffs, fade_to_total=0.7)[0]
            if np.mean(np.abs(v_sp_db - v_sp_db_sm)) < thres_db:
                break
            v_sp_db = np.maximum(v_sp_db, v_sp_db_sm)
        m_sp_db_env[f, :] = v_sp_db_sm
    if in_type == 'db':
        return m_sp_db_env
    if in_type == 'abs':
        return db(m_sp_db_env, b_inv=True)
    return (np.log(10.0) / 20.0) * m_sp_db_env


def f0_to_lf0(v_f0):
    """libaudio.py:458-465."""
    with np.errstate(divide='ignore'):
        v_lf0 = np.log(v_f0)
    v_lf0[np.isinf(v_lf0)] = MAGIC
    return v_lf0


def mcep_to_sp_cosmat(m_mcep, n_spbins, alpha=0.77, out_type='abs'):
    """libaudio.py:605-631 (warped cosine matrix dot product)."""
    n_cepcoeffs = m_mcep.shape[1]
    v_bins_out = np.linspace(0, np.pi, num=n_spbins)
    v_bins_warp = np.arctan(
        (1 - alpha ** 2) * np.sin(v_bins_out) /
        ((1 + alpha ** 2) * np.cos(v_bins_out) - 2 * alpha))
    v_bins_warp[v_bins_warp < 0] += np.pi
    m_trans = np.cos(np.arange(n_cepcoeffs)[:, None] * v_bins_warp[None, :])
    m_sp = np.dot(m_mcep, m_trans)
    if out_type == 'abs':
        return np.exp(m_sp)
    if out_type == 'db':
        return m_sp * (20 / np.log(10))
    return m_sp


def build_mel_curve(alpha, nbins, amp=np.pi):
    """libaudio.py:711-718."""
    v_bins = np.linspace(0, np.pi, nbins)
    v_bins_warp = np.arctan(
        (1 - alpha ** 2) * np.sin(v_bins) /
        ((1 + alpha ** 2) * np.cos(v_bins) - 2 * alpha))
    v_bins_warp[v_bins_warp < 0] += np.pi
    return v_bins_warp * (amp / np.pi)


def build_min_phase_from_mag_spec(m_mag):
    """libaudio.py:920-934."""
    m_log = protected_log(m_mag)
    m_log_ext = add_hermitian_half(m_log)
    m_rc = np.fft.ifft(m_log_ext).real
    nfft = m_rc.shape[1]
    half = nfft // 2 + 1
    m_rc[:, 1:(half - 1)] *= 2
    m_rc[:, half:] = 0
    m_minph_log = np.fft.fft(m_rc, n=nfft)
    m_minph = np.exp(remove_hermitian_half(m_minph_log))
    return m_minph


# ---------------------------------------------------------------------------
# SPTK mcep -j 0: independent restatement of SPTK-3.9 bin/mcep/_mcep.c
#
# The reference always invokes  mcep -a A -m M-1 -l L -e 1.0E-8 -j 0 -f 0.0
# -q {1,2,3}  (libaudio.py:589).  In mcep.c, -e sets etype=1/eps=1e-8 and
# -j sets itr2 (the MAXIMUM Newton iteration count) to 0, so _mcep.c's
# Newton loop ``for (j = 1; j <= itr2; j++)`` never executes and the output
# is exactly the initial estimate:
#
#   1. x[i] <- amplitude^2 + eps          (periodogram; -q converts input)
#   2. c[i] <- log x[i]                   (full length, mirrored)
#   3. c <- IFFT[c]                       (cepstrum of the log periodogram)
#   4. c[0] /= 2; c[L/2] /= 2             (endpoint halving)
#   5. mc <- freqt(c[0..L/2], M-1, a)     (_freqt.c recursion)
#
# -f 0.0 (determinant floor) only affects the Newton loop, so it is inert.

def freqt_sptk(c1, m2, a):
    """_freqt.c literal recursion: order-m1 cepstrum -> order-m2 warped
    cepstrum.  c1 may be (n,) or (frames, n); the recursion runs
    coefficient-serially exactly as the C does, batched over frames."""
    c1 = np.atleast_2d(np.asarray(c1, np.float64))
    nfrms, n1 = c1.shape
    m1 = n1 - 1
    b = 1 - a * a
    g = np.zeros((nfrms, m2 + 1))
    for i in range(-m1, 1):
        d = g.copy()
        g[:, 0] = c1[:, -i] + a * d[:, 0]
        if m2 >= 1:
            g[:, 1] = b * d[:, 0] + a * d[:, 1]
        for j in range(2, m2 + 1):
            g[:, j] = d[:, j - 1] + a * (d[:, j] - g[:, j - 1])
    return g


def mcep_j0(m_sp, n_coeffs, alpha, in_type, fft_len=0, eps=1.0e-8):
    """_mcep.c with itr2=0 — the exact semantics of the reference's
    ``sp_to_mcep`` subprocess call (libaudio.py:575-601)."""
    m_sp = np.atleast_2d(np.asarray(m_sp, np.float64))
    if fft_len == 0:
        fft_len = 2 * (m_sp.shape[1] - 1)
    f2 = fft_len // 2
    if in_type == 3:
        amp = m_sp
    elif in_type == 1:
        amp = 10.0 ** (m_sp / 20.0)
    elif in_type == 2:
        amp = np.exp(m_sp)
    else:
        raise ValueError(in_type)
    x = amp * amp + eps                      # _mcep.c: periodogram + eps
    c = np.log(x)
    cp = np.fft.irfft(c, n=fft_len)          # ifftr of the mirrored log
    cp[:, 0] /= 2.0
    cp[:, f2] /= 2.0
    return freqt_sptk(cp[:, :f2 + 1], n_coeffs - 1, alpha)


def sp_to_mcep(m_sp, n_coeffs=60, alpha=0.77, in_type=3, fft_len=0):
    """libaudio.py:575-601 with the subprocess replaced by mcep_j0."""
    return mcep_j0(m_sp, n_coeffs, alpha, in_type, fft_len=fft_len)


def sp_mel_warp(m_sp, nbins_out, alpha=0.77, in_type=3):
    """libaudio.py:643-661."""
    m_mcep = sp_to_mcep(m_sp, n_coeffs=nbins_out, alpha=alpha,
                        in_type=in_type)
    out_type = {3: 'abs', 1: 'db', 2: 'log'}[in_type]
    return mcep_to_sp_cosmat(m_mcep, nbins_out, alpha=0.0, out_type=out_type)


def sp_mel_unwarp(m_sp_mel, nbins_out, alpha=0.77, in_type='log'):
    """libaudio.py:667-684 (note the reference's doubling range stops at
    ncoeffs-2 — one bin early relative to the true hermitian midpoint —
    reproduced verbatim)."""
    ncoeffs = m_sp_mel.shape[1]
    if in_type == 'abs':
        m_sp_mel = np.log(m_sp_mel)
    m_sp_mel = add_hermitian_half(m_sp_mel, data_type='magnitude')
    m_mcep = np.fft.ifft(m_sp_mel).real
    m_mcep[:, 1:(ncoeffs - 2)] *= 2
    return mcep_to_sp_cosmat(m_mcep[:, :ncoeffs], nbins_out, alpha=alpha,
                             out_type=in_type)


# ---------------------------------------------------------------------------
# magphase.py ports — framing / windowing / OLA

def raised_hanning(length, att=1.0):
    """magphase.py:25-31."""
    return (1 - att) + att * np.hanning(length)


def voi_noise_window(length):
    """magphase.py:67-68."""
    return np.bartlett(length) ** 2.5


def windowing(v_sig, v_pm, win_func=np.hanning):
    """magphase.py:74-119 (ragged pitch-sync frames; the ``callable(open)``
    branch at :106 is always True, so a scalar win_func is always applied)."""
    n_smpls = np.size(v_sig)
    v_pm = round_to_int(v_pm)
    v_pm_plus = np.hstack((0, v_pm, (n_smpls - 1)))
    n_pm = np.size(v_pm_plus) - 2
    v_lens = np.zeros(n_pm, dtype=int)
    v_shift = np.zeros(n_pm, dtype=int)
    v_rights = np.zeros(n_pm, dtype=int)
    l_frames = []
    for f in range(n_pm):
        left_lim = v_pm_plus[f]
        pm = v_pm_plus[f + 1]
        right_lim = v_pm_plus[f + 2]
        v_frm = v_sig[left_lim:(right_lim + 1)]
        left_len = pm - left_lim
        right_len = right_lim - pm
        if isinstance(win_func, list):
            v_win = gen_non_symmetric_win(left_len, right_len, win_func[f])
        else:
            v_win = gen_non_symmetric_win(left_len, right_len, win_func)
        v_frm = v_frm * v_win
        l_frames.append(v_frm)
        v_lens[f] = len(v_frm)
        v_shift[f] = left_len
        v_rights[f] = right_len
    return l_frames, v_lens, v_pm_plus, v_shift, v_rights


def ola(m_frm, v_pm, win_func=None):
    """magphase.py:34-62 (sequential scatter-add + boundary trims;
    frmlen/2 is Python-2 integer division)."""
    v_pm = v_pm.astype(int)
    nfrms, frmlen = m_frm.shape
    v_sig = np.zeros(v_pm[-1] + frmlen)
    v_shift = pm_to_shift(v_pm)
    v_shift = np.append(v_shift, v_shift[-1])
    strt = 0
    for i in range(nfrms):
        if win_func is not None:
            v_win = gen_centr_win(v_shift[i], v_shift[i + 1], frmlen,
                                  win_func=win_func)
            m_frm[i, :] *= v_win
        v_sig[strt:(strt + frmlen)] += m_frm[i, :]
        strt += v_shift[i + 1]
    v_sig = v_sig[(frmlen // 2 - v_pm[0]):]
    v_sig = v_sig[:(v_pm[-1] + v_shift[-1] + 1)]
    return v_sig


# ---------------------------------------------------------------------------
# magphase.py ports — analysis

def densify_pitch_marks(v_pm_smpls, nwin_per_pitch_period):
    """magphase.py:280-288 (intermediate-epoch densification)."""
    n_eps = int(nwin_per_pitch_period * 2)
    v_diff = np.diff(v_pm_smpls)
    v_step = v_diff / float(n_eps)
    m_step = np.tile(v_step, (n_eps, 1))
    m_step = np.multiply(m_step, np.arange(n_eps)[:, None])
    m_step = np.add(m_step, v_pm_smpls[:-1])
    return m_step.flatten(order='F')


def analysis_with_del_comp_from_pm(v_in_sig, fs, v_pm_smpls, fft_len=None,
                                   win_func=np.hanning,
                                   nwin_per_pitch_period=0.5):
    """magphase.py:266-334 (live core analysis: pitch-sync windowing,
    zero-pad, circular delay compensation, batched FFT)."""
    if fft_len is None:
        fft_len = define_fft_len(fs)
    v_pm_smpls_defi = v_pm_smpls
    if nwin_per_pitch_period >= 1.0:
        v_pm_smpls_defi = densify_pitch_marks(v_pm_smpls,
                                              nwin_per_pitch_period)
    l_frms, v_lens, v_pm_plus, v_shift, v_rights = windowing(
        v_in_sig, v_pm_smpls_defi, win_func=win_func)
    n_frms = len(l_frms)
    m_frms = np.zeros((n_frms, fft_len))
    for f in range(n_frms):
        if v_lens[f] <= fft_len:
            m_frms[f, 0:v_lens[f]] = l_frms[f]
        else:
            m_frms[f, :] = l_frms[f][:fft_len]
        v_curr_frm = m_frms[f, :]
        m_frms[f, :] = np.hstack((v_curr_frm[v_shift[f]:],
                                  v_curr_frm[0:v_shift[f]]))
    m_fft = np.fft.fft(m_frms)
    m_fft = remove_hermitian_half(m_fft)
    return m_fft, v_shift


def analysis_with_del_comp_from_pm_type2(v_in_sig, fs, v_pm_smpls, v_voi,
                                         fft_len=None, win_func=np.hanning,
                                         nwin_per_pitch_period=0.5):
    """magphase.py:182-260 (same + per-frame gain: max|first half| voiced,
    std of ragged frame unvoiced)."""
    if fft_len is None:
        fft_len = define_fft_len(fs)
    v_pm_smpls_defi = v_pm_smpls
    if nwin_per_pitch_period >= 1.0:
        v_pm_smpls_defi = densify_pitch_marks(v_pm_smpls,
                                              nwin_per_pitch_period)
    l_frms, v_lens, v_pm_plus, v_shift, v_rights = windowing(
        v_in_sig, v_pm_smpls_defi, win_func=win_func)
    n_frms = len(l_frms)
    m_frms = np.zeros((n_frms, fft_len))
    v_gain = np.zeros(n_frms)
    fft_len_half = fft_len // 2 + 1
    for f in range(n_frms):
        if v_lens[f] <= fft_len:
            m_frms[f, 0:v_lens[f]] = l_frms[f]
        else:
            m_frms[f, :] = l_frms[f][:fft_len]
        v_curr_frm = m_frms[f, :]
        m_frms[f, :] = np.hstack((v_curr_frm[v_shift[f]:],
                                  v_curr_frm[0:v_shift[f]]))
        if v_voi[f] == 1:
            v_gain[f] = np.max(np.abs(m_frms[f, :fft_len_half]))
        else:
            v_gain[f] = np.std(l_frms[f])
    m_fft = np.fft.fft(m_frms)
    m_fft = remove_hermitian_half(m_fft)
    return m_fft, v_shift, v_gain


def shift_to_f0(v_shift, v_voi, fs, out='f0', b_smooth=True):
    """magphase.py:2198-2207."""
    v_f0 = v_voi * fs / v_shift.astype('float64')
    if b_smooth:
        v_f0 = v_voi * sp_signal.medfilt(v_f0)
    if out == 'lf0':
        v_f0 = f0_to_lf0(v_f0)
    return v_f0


def f0_to_shift(v_f0_in, fs, unv_frm_rate_ms=5):
    """magphase.py:2210-2215."""
    v_f0 = v_f0_in.copy()
    v_f0[v_f0 == 0] = 1000.0 / unv_frm_rate_ms
    return fs / v_f0


def compute_lossless_feats(m_fft, v_shift, v_voi, fs):
    """magphase.py:457-476."""
    m_mag = np.absolute(m_fft)
    mb_mag_zeros = (m_mag == 0.0)
    m_div = m_mag.copy()
    m_div[mb_mag_zeros] = 1.0
    m_real = m_fft.real / m_div
    m_imag = m_fft.imag / m_div
    m_real[mb_mag_zeros] = 0.0
    m_imag[mb_mag_zeros] = 0.0
    v_f0 = shift_to_f0(v_shift, v_voi, fs, out='f0', b_smooth=False)
    return m_mag, m_real, m_imag, v_f0


def analysis_lossless(v_sig, fs, v_pm_sec, v_voi, fft_len=None):
    """magphase.py:2869-2906 with epochs supplied (the REAPER subprocess
    replaced by fixed pm/voi inputs shared with the framework under test)."""
    v_pm_smpls = v_pm_sec * fs
    m_fft, v_shift = analysis_with_del_comp_from_pm(v_sig, fs, v_pm_smpls,
                                                    fft_len=fft_len)
    m_mag, m_real, m_imag, v_f0 = compute_lossless_feats(m_fft, v_shift,
                                                         v_voi, fs)
    return m_mag, m_real, m_imag, v_f0, fs, v_shift


def analysis_lossless_type2(v_sig, fs, v_pm_sec, v_voi, fft_len=None,
                            te_ncoeffs=600):
    """magphase.py:2793-2866 with epochs supplied: even/odd pitch-mark
    interleave for the magnitude stream, true-envelope, separate type2
    phase analysis with gain.  ``te_ncoeffs`` mirrors the hard-coded 600
    (kept a parameter so tests can run cheaper FFT sizes)."""
    v_pm_smpls = v_pm_sec * fs
    v_nx_even = np.arange(0, v_pm_smpls.size, 2)
    v_nx_odd = np.arange(1, v_pm_smpls.size, 2)
    m_fft_even, _ = analysis_with_del_comp_from_pm(
        v_sig, fs, v_pm_smpls[v_nx_even], fft_len=fft_len)
    m_fft_odd, _ = analysis_with_del_comp_from_pm(
        v_sig, fs, v_pm_smpls[v_nx_odd], fft_len=fft_len)
    nfrms = m_fft_even.shape[0] + m_fft_odd.shape[0]
    nfft_half = m_fft_even.shape[1]
    m_fft = np.zeros((nfrms, nfft_half), dtype=complex)
    m_fft[v_nx_even, :] = m_fft_even
    m_fft[v_nx_odd, :] = m_fft_odd
    m_fft = m_fft[1:, :]
    v_shift = pm_to_shift(v_pm_smpls[1:])
    m_mag_long, m_real_long, m_imag_long, v_f0_long = compute_lossless_feats(
        m_fft, v_shift, v_voi[1:], fs)
    m_mag_env = true_envelope(m_mag_long, in_type='abs', ncoeffs=te_ncoeffs,
                              thres_db=0.1)
    m_fft_phase, v_shift_phase, v_gain = analysis_with_del_comp_from_pm_type2(
        v_sig, fs, v_pm_smpls, v_voi, fft_len=fft_len)
    m_mag, m_real, m_imag, v_f0 = compute_lossless_feats(
        m_fft_phase, v_shift_phase, v_voi, fs)
    m_real = m_real[1:]
    m_imag = m_imag[1:]
    v_f0 = v_f0[1:]
    v_gain = v_gain[1:]
    return m_mag_env, m_real, m_imag, v_f0, fs, v_shift, v_gain


# ---------------------------------------------------------------------------
# magphase.py ports — compression / decompression

def define_alpha(fs):
    """magphase.py:3279-3290."""
    return {16000: 0.58, 22050: 0.65, 44100: 0.76, 48000: 0.77}[fs]


def define_fft_len(fs):
    """magphase.py:3292-3299."""
    if fs in (22050, 16000):
        return 2048
    if fs == 8000:
        return 1024
    return 4096


def define_crossfade_params(fs):
    """magphase.py:3301-3317."""
    crsf_bw = 2000
    crsf_cf = {48000: 5000, 16000: 2500, 44100: 4500, 22050: 3500}.get(
        fs, 3500)
    return crsf_cf, crsf_bw


def get_num_full_mel_coeffs_from_num_phase_coeffs(freq_hz, phase_dim, alpha,
                                                  fs):
    """magphase.py:2479-2487."""
    crsf_cw = 2 * np.pi * freq_hz / float(fs)
    crsf_cf_mel = np.arctan((1 - alpha ** 2) * np.sin(crsf_cw) /
                            ((1 + alpha ** 2) * np.cos(crsf_cw) - 2 * alpha))
    if crsf_cf_mel < 0:
        crsf_cf_mel += np.pi
    return round_to_int(1 + (np.pi * (phase_dim - 1) / float(crsf_cf_mel)))


def format_for_modelling(m_mag, m_real, m_imag, v_f0, fs, mag_dim=60,
                         phase_dim=45, alpha_phase=None):
    """magphase.py:2490-2544 (live compressor; b_mag_fbank_mel=False)."""
    alpha = define_alpha(fs)
    v_voi = (v_f0 > 0).astype('float')
    v_f0_smth = v_voi * sp_signal.medfilt(v_f0)
    v_lf0_smth = f0_to_lf0(v_f0_smth)
    m_mag_mel = sp_mel_warp(m_mag, mag_dim, alpha=alpha, in_type=3)
    m_mag_mel_log = protected_log(m_mag_mel)
    crsf_cf, crsf_bw = define_crossfade_params(fs)
    if alpha_phase is None:
        alpha_phase = alpha
    mag_dim_for_phase_comp = get_num_full_mel_coeffs_from_num_phase_coeffs(
        crsf_cf, phase_dim, alpha_phase, fs)
    m_real_mel = sp_mel_warp(m_real, mag_dim_for_phase_comp,
                             alpha=alpha_phase, in_type=2)
    m_imag_mel = sp_mel_warp(m_imag, mag_dim_for_phase_comp,
                             alpha=alpha_phase, in_type=2)
    m_real_mel = m_real_mel[:, :phase_dim]
    m_imag_mel = m_imag_mel[:, :phase_dim]
    m_real_mel = np.clip(m_real_mel * v_voi[:, None], -1, 1)
    m_imag_mel = np.clip(m_imag_mel * v_voi[:, None], -1, 1)
    return m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0_smth


def phase_uncompress_type1_mcep(m_real_mel, m_imag_mel, alpha, fft_len, fs):
    """magphase.py:1219-1235."""
    ncoeffs_comp = m_real_mel.shape[1]
    crsf_cf = define_crossfade_params(fs)[0]
    mag_dim_for_phase_comp = get_num_full_mel_coeffs_from_num_phase_coeffs(
        crsf_cf, ncoeffs_comp, alpha, fs)
    f_r = sp_interpolate.interp1d(np.arange(ncoeffs_comp), m_real_mel,
                                  kind='nearest', fill_value='extrapolate')
    f_i = sp_interpolate.interp1d(np.arange(ncoeffs_comp), m_imag_mel,
                                  kind='nearest', fill_value='extrapolate')
    m_real_mel = f_r(np.arange(mag_dim_for_phase_comp))
    m_imag_mel = f_i(np.arange(mag_dim_for_phase_comp))
    fft_len_half = 1 + fft_len // 2
    m_real = sp_mel_unwarp(m_real_mel, fft_len_half, alpha=alpha,
                           in_type='log')
    m_imag = sp_mel_unwarp(m_imag_mel, fft_len_half, alpha=alpha,
                           in_type='log')
    return m_real, m_imag


def post_filter(m_mag_mel_log, fs, av_len_at_zero=None, av_len_at_nyq=None,
                boost_at_zero=None, boost_at_nyq=None):
    """magphase.py:2300-2378 (per-frame variable-length moving average)."""
    nfrms, mag_dim = m_mag_mel_log.shape
    if fs == 48000:
        av_len_at_zero = av_len_at_zero or round_to_int(11.0 * (mag_dim / 60.0))
        av_len_at_nyq = av_len_at_nyq or round_to_int(3.0 * (mag_dim / 60.0))
        boost_at_zero = boost_at_zero or 1.8
        boost_at_nyq = boost_at_nyq or 2.0
    elif fs == 16000:
        av_len_at_zero = av_len_at_zero or round_to_int(9.0 * (mag_dim / 60.0))
        av_len_at_nyq = av_len_at_nyq or round_to_int(12.0 * (mag_dim / 60.0))
        boost_at_zero = boost_at_zero or 2.0
        boost_at_nyq = boost_at_nyq or 1.6
    v_ave = np.zeros(mag_dim)
    v_nx = np.arange(np.floor(av_len_at_zero / 2),
                     mag_dim - np.floor(av_len_at_nyq / 2)).astype(int)
    v_lens = np.linspace(av_len_at_zero, av_len_at_nyq, v_nx.size)
    v_lens = (2 * np.ceil(v_lens / 2) - 1).astype(int)
    m_out = np.zeros(m_mag_mel_log.shape)
    for nxf in range(nfrms):
        v_mag = m_mag_mel_log[nxf, :]
        for nxb in v_nx:
            halflen = np.floor(v_lens[nxb - v_nx[0]] / 2).astype(int)
            v_ave[nxb] = np.mean(v_mag[(nxb - halflen):(nxb + halflen + 1)])
        v_ave[:v_nx[0]] = v_ave[v_nx[0]]
        v_ave[v_nx[-1]:] = v_ave[v_nx[-1]]
        v_norm = v_mag - v_ave
        v_tilt = np.linspace(boost_at_zero, boost_at_nyq, mag_dim)
        v_enh = (v_norm * v_tilt) + v_ave
        v_enh[0] = v_mag[0]
        v_enh[-1] = v_mag[-1]
        m_out[nxf, :] = v_enh
    return m_out


# ---------------------------------------------------------------------------
# magphase.py ports — synthesis

def synthesis_from_lossless(m_mag, m_real, m_imag, v_f0, fs):
    """magphase.py:1759-1776 (deterministic resynthesis)."""
    m_ph_cmpx = m_real + m_imag * 1j
    m_ph_cmpx_mag = np.absolute(m_ph_cmpx)
    m_ph_cmpx_mag[m_ph_cmpx_mag == 0.0] = 1.0
    m_fft = m_mag * m_ph_cmpx / m_ph_cmpx_mag
    m_fft = add_hermitian_half(m_fft, data_type='complex')
    m_frm = np.fft.ifft(m_fft).real
    m_frm = np.fft.fftshift(m_frm, axes=1)
    v_shift = f0_to_shift(v_f0, fs, unv_frm_rate_ms=5)
    v_pm = shift_to_pm(v_shift)
    return ola(m_frm, v_pm)


def synthesis_from_compressed(m_mag_mel_log, m_real_mel, m_imag_mel, v_lf0,
                              fs, fft_len=None, b_voi_ap_win=True,
                              per_phase_type='magphase', alpha_phase=None,
                              b_out_hpf=True, v_ns=None):
    """magphase.py:825-997, b_fbank_mel=False, b_const_rate=False.

    ``v_ns``: inject the uniform[-1,1] noise signal (the reference draws it
    unseeded at :883); pass the same array to any implementation under
    comparison to make the whole pipeline deterministic.
    """
    crsf_cf, crsf_bw = define_crossfade_params(fs)
    alpha = define_alpha(fs)
    if fft_len is None:
        fft_len = define_fft_len(fs)
    fft_len_half = fft_len // 2 + 1
    nfrms, ncoeffs_mag = m_mag_mel_log.shape

    v_f0 = np.exp(v_lf0)
    v_voi = v_f0 > 1.0
    v_shift = f0_to_shift(v_f0, fs)

    m_mag = np.exp(sp_mel_unwarp(m_mag_mel_log, fft_len_half, alpha=alpha,
                                 in_type='log'))
    if alpha_phase is None:
        alpha_phase = alpha
    m_real, m_imag = phase_uncompress_type1_mcep(m_real_mel, m_imag_mel,
                                                 alpha_phase, fft_len, fs)

    # Mask generation (:873-875)
    m_mask_per = np.zeros(m_mag.shape)
    m_ones = np.ones((np.sum(v_voi.astype(int)), fft_len_half))
    m_mask_per[v_voi, :] = spectral_crossfade(
        m_ones, m_mask_per[v_voi, :], crsf_cf, crsf_bw, fs, freq_scale='hz',
        win_func=np.hanning)

    # Aperiodic spectrum (:877-918)
    v_shift = v_shift.astype(int)
    v_pm = shift_to_pm(v_shift)
    ns_len = v_pm[-1] + (v_pm[-1] - v_pm[-2])
    if v_ns is None:
        v_ns = np.random.uniform(-1, 1, ns_len)
    assert len(v_ns) == ns_len
    l_ns_win_funcs = [np.hanning] * nfrms
    if b_voi_ap_win:
        for i in range(nfrms):
            if v_voi[i]:
                l_ns_win_funcs[i] = voi_noise_window
    l_frm_ns, v_lens, v_pm_plus, v_shift_dummy, v_rights = windowing(
        v_ns, v_pm, win_func=l_ns_win_funcs)
    m_frm_ns = frm_list_to_matrix(l_frm_ns, v_shift, fft_len)
    m_frm_ns = np.fft.fftshift(m_frm_ns, axes=1)
    m_ns_cmplx_spec = remove_hermitian_half(np.fft.fft(m_frm_ns))
    m_ns_mag = np.absolute(m_ns_cmplx_spec)
    noise_gain_voi = np.sqrt(np.exp(np.mean(
        protected_log(m_ns_mag[v_voi, 1:-1]) ** 2)))
    noise_gain_unv = np.sqrt(np.exp(np.mean(
        protected_log(m_ns_mag[~v_voi, 1:-1]) ** 2)))
    m_ns_cmplx_spec[v_voi, :] = m_ns_cmplx_spec[v_voi, :] / noise_gain_voi
    m_ns_cmplx_spec[~v_voi, :] = m_ns_cmplx_spec[~v_voi, :] / noise_gain_unv
    m_ap_cmplx_spec = m_ns_cmplx_spec * m_mag
    v_line = db(build_mel_curve(alpha, fft_len_half, amp=3.5) - 3.5,
                b_inv=True)
    m_ap_cmplx_spec[~v_voi, :] *= v_line

    # Periodic spectrum (:921-941)
    if per_phase_type == 'magphase':
        m_per_cmplx_ph = m_real + m_imag * 1j
        m_per_cmplx_ph_mag = np.absolute(m_per_cmplx_ph)
        m_per_cmplx_ph_mag[m_per_cmplx_ph_mag == 0.0] = 1.0
        m_per_cmplx_spec = m_mag * m_per_cmplx_ph / m_per_cmplx_ph_mag
    elif per_phase_type == 'linear':
        m_per_cmplx_spec = m_mag
    elif per_phase_type == 'min_phase':
        m_per_cmplx_spec = build_min_phase_from_mag_spec(m_mag)
    v_line = db(build_mel_curve(0.6, fft_len_half, amp=2.0), b_inv=True)
    m_per_cmplx_spec = m_per_cmplx_spec.astype(complex)
    m_per_cmplx_spec[v_voi, :] *= v_line

    # Masks + synthesis (:944-976)
    crsf_curve_fact = 0.5
    m_per_cmplx_spec *= (m_mask_per ** crsf_curve_fact)
    m_ap_cmplx_spec *= ((1 - m_mask_per) ** crsf_curve_fact)
    m_per_cmplx_spec[m_mask_per == 0.0] = 0 + 0j
    m_ap_cmplx_spec[m_mask_per == 1.0] = 0 + 0j
    m_syn_cmplx = m_per_cmplx_spec + m_ap_cmplx_spec
    m_syn_cmplx[:, 0] = np.absolute(m_syn_cmplx[:, 0])
    m_syn_cmplx[:, -1] = np.absolute(m_syn_cmplx[:, -1])
    m_syn_cmplx = add_hermitian_half(m_syn_cmplx, data_type='complex')
    m_syn_frms = np.fft.ifft(m_syn_cmplx).real
    m_syn_frms = np.fft.fftshift(m_syn_frms, axes=1)

    # Anti-ringing (:968-973)
    frmlen = m_syn_frms.shape[1]
    v_shift_ext = np.r_[v_shift[0], v_shift, v_shift[-1], v_shift[-1]]
    for nxf in range(nfrms):
        v_win = gen_centr_win(v_shift_ext[nxf] + v_shift_ext[nxf + 1],
                              v_shift_ext[nxf + 2] + v_shift_ext[nxf + 3],
                              frmlen, win_func=raised_hanning,
                              b_fill_w_bound_val=True)
        m_syn_frms[nxf, :] *= v_win

    v_syn_sig = ola(m_syn_frms, v_pm, win_func=None)

    if b_out_hpf:
        order = 4
        fc = 40
        fc_norm = fc / (fs / 2.0)
        v_b, v_a = sp_signal.butter(order, fc_norm, btype='highpass')
        v_syn_sig = sp_signal.lfilter(v_b, v_a, v_syn_sig)
    return v_syn_sig
