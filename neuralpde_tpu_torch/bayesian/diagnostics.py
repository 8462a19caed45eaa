"""MCMC convergence diagnostics: split-R̂ and effective sample size
(`neuralpde_tpu.bayesian.diagnostics`, numpy only, kept here as a copy so
that the port imports nothing of the JAX package).

The reference gets these free from MCMCChains.jl summaries on the
AdvancedHMC output (reference: ext/bpinn/advancedHMC_MCMC.jl:542-555 returns
`mcmc_chain = Chains(...)`); here they are computed directly from the draw
arrays (Gelman et al., BDA3 §11.4-11.5; Geyer initial monotone sequence for
the autocorrelation truncation — the same estimators Stan reports).

Host-side post-processing on numpy: diagnostics are not in any hot path.
"""

from __future__ import annotations

import numpy as np


def _to_chains(samples) -> np.ndarray:
    """Normalize input to (n_chains, draws, dim)."""
    if hasattr(samples, "detach"):
        samples = samples.detach().cpu().numpy()
    a = np.asarray(samples, dtype=np.float64)
    if a.ndim == 1:
        a = a[None, :, None]
    elif a.ndim == 2:
        a = a[None, :, :]
    elif a.ndim != 3:
        raise ValueError(f"expected (draws,), (draws, dim) or "
                         f"(chains, draws, dim); got shape {a.shape}")
    return a


def _split(chains: np.ndarray) -> np.ndarray:
    """Split each chain in half -> (2*chains, draws//2, dim)."""
    m, n, d = chains.shape
    half = n // 2
    if half < 2:
        raise ValueError("need at least 4 draws per chain for split "
                         "diagnostics")
    return np.concatenate([chains[:, :half], chains[:, n - half:]], axis=0)


def split_rhat(samples) -> np.ndarray:
    """Split-R̂ per parameter (BDA3 eq. 11.4; < 1.01 indicates convergence).

    ``samples``: (draws, dim) for one chain or (chains, draws, dim); each
    chain is split in half, so a single chain still yields a meaningful
    stationarity check.  Returns (dim,).
    """
    c = _split(_to_chains(samples))
    m, n, d = c.shape
    chain_means = c.mean(axis=1)                        # (m, d)
    W = c.var(axis=1, ddof=1).mean(axis=0)              # within
    B = n * chain_means.var(axis=0, ddof=1)             # between
    var_plus = (n - 1) / n * W + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.sqrt(var_plus / W)
    # W == 0 is only "converged" when the chains are all stuck at the SAME
    # value; distinct constant chains (B > 0) are the worst non-convergence
    # and must report inf, as Stan does
    return np.where(W > 0, out, np.where(B > 0, np.inf, 1.0))


def ess(samples) -> np.ndarray:
    """Bulk effective sample size per parameter (BDA3 eq. 11.8 with Geyer's
    initial monotone positive sequence truncation, computed on split
    chains — Stan's `ess_bulk` without rank normalization).

    Returns (dim,); capped at the total draw count.
    """
    c = _split(_to_chains(samples))
    m, n, d = c.shape
    chain_means = c.mean(axis=1, keepdims=True)
    W = c.var(axis=1, ddof=1).mean(axis=0)
    B = n * c.mean(axis=1).var(axis=0, ddof=1)
    var_plus = (n - 1) / n * W + B / n

    # per-chain autocovariance via FFT, averaged over chains: (n, d)
    x = c - chain_means
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real / n
    acov_mean = acov.mean(axis=0)                       # (n, d)

    out = np.empty(d)
    for j in range(d):
        if var_plus[j] <= 0:
            out[j] = m * n
            continue
        rho = 1.0 - (W[j] - acov_mean[:, j]) / var_plus[j]
        rho[0] = 1.0
        # Geyer pairs Γ_k = ρ_{2k} + ρ_{2k+1}: truncate at the first
        # non-positive pair, enforce non-increasing, τ = -1 + 2 Σ Γ_k
        K = n // 2
        gam = rho[:2 * K].reshape(K, 2).sum(axis=1)
        nonpos = np.nonzero(gam <= 0)[0]
        if nonpos.size:
            gam = gam[:nonpos[0]]
        if gam.size == 0:
            out[j] = m * n
            continue
        gam = np.minimum.accumulate(gam)
        tau = max(-1.0 + 2.0 * gam.sum(), 1.0 / (m * n))
        out[j] = min(m * n / tau, m * n)
    return out


def summarize(samples) -> dict:
    """{"ess": (dim,), "split_rhat": (dim,), "mean": (dim,), "std": (dim,)}"""
    c = _to_chains(samples)
    flat = c.reshape(-1, c.shape[-1])
    return {"ess": ess(samples), "split_rhat": split_rhat(samples),
            "mean": flat.mean(axis=0), "std": flat.std(axis=0, ddof=1)}
