"""The plain reference of RandomPatchCifarKernel, in float64, written from
KeystoneML's description of the application and imports nothing of the
port. From the images, the labels and the seed it works out again every
stage the program derives:

1. filters: ``whitener_size`` patches sampled over all windows (numpy
   ``default_rng(seed).choice`` without replacement, sorted), each row
   normalized (mean 0, divided by sqrt(var + 10), ddof 1), a ZCA whitener
   W = V diag((σ²/(n−1) + ε)^−½) Vᵀ from an SVD of the centered sample,
   ``num_filters`` sampled rows (a second ``default_rng(seed).choice``)
   whitened, scaled to unit norm and rotated back by Wᵀ;
2. features: every patch normalized as above, (p̂ − means)·f for each
   filter, rectified both ways at α ([max(0, x − α), max(0, −x − α)]), sum
   pooled over windows of ``2·(pool_size // 2)`` every ``pool_stride``,
   laid out channel-major (c + x·C + y·X·C);
3. the scaler: column mean and std (ddof 1, a std under 1e-12 read as 1);
4. Gauss-Seidel kernel ridge regression over column blocks of
   ``block_size`` in the order ``default_rng(seed).shuffle`` draws each
   epoch: (K_BB + λI) W_B = Y_B − (K_·Bᵀ W − K_BBᵀ W_B), with
   K = exp(−γ‖x − y‖²) and Y the ±1 class indicators;
5. scores: Σ_B K(X, X_B) W_B, of the train and the test set (a run's),
   or of each batch a batch loop scores.

A patch vector is laid out c + px·C + py·C·S. Everything runs in blocks of
rows so that the largest intermediate is a few GB."""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
IMAGES_A_BLOCK = 1000


def _patch_vectors(X: torch.Tensor, S: int, step: int) -> torch.Tensor:
    """(n, nx, ny, S·S·C) patch vectors of (n, X, Y, C) images."""
    p = X.unfold(1, S, step).unfold(2, S, step)  # (n, nx, ny, C, px, py)
    n, nx, ny = p.shape[:3]
    return p.permute(0, 1, 2, 5, 4, 3).reshape(n, nx, ny, -1)


def _normalize(p: torch.Tensor, var_constant: float = 10.0) -> torch.Tensor:
    mu = p.mean(dim=-1, keepdim=True)
    var = ((p - mu) ** 2).sum(dim=-1, keepdim=True) / (p.shape[-1] - 1)
    return (p - mu) / torch.sqrt(var + var_constant)


def learn_filters(X: torch.Tensor, cfg: dict, seed: int):
    """(filters (K, m), whitener (m, m), means (m,)) in float64."""
    S, step = cfg["patch_size"], cfg["patch_steps"]
    n, side = X.shape[0], X.shape[1]
    nx = ny = (side - S) // step + 1
    total = n * nx * ny
    idx = np.sort(np.random.default_rng(seed).choice(
        total, size=min(cfg["whitener_size"], total), replace=False))
    idx = torch.from_numpy(idx).to(X.device)
    img, rem = idx // (nx * ny), idx % (nx * ny)
    xi, yi = rem // ny, rem % ny
    off = torch.arange(S, device=X.device)
    xs = (xi * step)[:, None] + off
    ys = (yi * step)[:, None] + off
    win = X[img[:, None, None], xs[:, :, None], ys[:, None, :], :].to(F64)  # (k, px, py, C)
    base = _normalize(win.permute(0, 2, 1, 3).reshape(win.shape[0], -1))
    means = base.mean(dim=0)
    _, s, vt = torch.linalg.svd(base - means, full_matrices=False)
    scale = (s * s / (base.shape[0] - 1.0) + cfg["whitening_epsilon"]) ** -0.5
    whitener = vt.T @ (scale[:, None] * vt)
    pick = np.sort(np.random.default_rng(seed).choice(
        base.shape[0], size=min(cfg["num_filters"], base.shape[0]), replace=False))
    unnorm = (base[torch.from_numpy(pick).to(X.device)] - means) @ whitener
    norms = torch.sqrt((unnorm * unnorm).sum(dim=1))
    filters = (unnorm / (norms + 1e-10)[:, None]) @ whitener.T
    return filters, whitener, means


def featurize(X: torch.Tensor, filters: torch.Tensor, means: torch.Tensor,
              cfg: dict) -> torch.Tensor:
    """(n, features) float64 features of (n, X, Y, C) images."""
    S, step, alpha = cfg["patch_size"], cfg["patch_steps"], cfg["alpha"]
    ps, st = cfg["pool_size"], cfg["pool_stride"]
    width = 2 * (ps // 2)
    rows = []
    for i in range(0, X.shape[0], IMAGES_A_BLOCK):
        p = _normalize(_patch_vectors(X[i:i + IMAGES_A_BLOCK].to(F64), S, step))
        conv = (p - means) @ filters.T  # (b, nx, ny, K)
        rect = torch.cat([torch.clamp_min(conv - alpha, 0), torch.clamp_min(-conv - alpha, 0)],
                         dim=-1)
        side = rect.shape[1]
        npool = max(1, -(-(side - ps // 2) // st))
        pooled = torch.stack([
            torch.stack([rect[:, x0:x0 + width, y0:y0 + width].sum(dim=(1, 2))
                         for y0 in range(0, npool * st, st)], dim=1)
            for x0 in range(0, npool * st, st)], dim=1)  # (b, x, y, C2)
        rows.append(pooled.permute(0, 2, 1, 3).reshape(pooled.shape[0], -1))
    return torch.cat(rows)


def scaler(F: torch.Tensor):
    mean = F.mean(dim=0)
    std = F.std(dim=0, correction=1)
    bad = torch.isnan(std) | torch.isinf(std) | (std.abs() < 1e-12)
    return mean, torch.where(bad, torch.ones_like(std), std)


def kernel(A: torch.Tensor, B: torch.Tensor, gamma: float) -> torch.Tensor:
    sq = (A * A).sum(dim=1)[:, None] - 2.0 * (A @ B.T) + (B * B).sum(dim=1)[None, :]
    return torch.exp(-gamma * torch.clamp_min(sq, 0.0))


def krr(Xs: torch.Tensor, y: torch.Tensor, cfg: dict, seed: int) -> torch.Tensor:
    """Gauss-Seidel block kernel ridge regression: the (n, k) weights."""
    n, bs, lam, gamma = Xs.shape[0], cfg["block_size"], cfg["lambda"], cfg["gamma"]
    Y = 2.0 * torch.nn.functional.one_hot(y, cfg["num_classes"]).to(F64) - 1.0
    W = torch.zeros_like(Y)
    rng = np.random.default_rng(seed)
    blocks = -(-n // bs)
    for _ in range(cfg["num_epochs"]):
        order = list(range(blocks))
        rng.shuffle(order)
        for blk in order:
            s, e = blk * bs, min(blk * bs + bs, n)
            Kb = kernel(Xs, Xs[s:e], gamma)
            Kbb = Kb[s:e]
            rhs = Y[s:e] - (Kb.T @ W - Kbb.T @ W[s:e])
            eye = torch.eye(e - s, dtype=F64, device=Xs.device)
            W[s:e] = torch.cholesky_solve(rhs, torch.linalg.cholesky(Kbb + lam * eye))
    return W


def scores(Xs_new: torch.Tensor, Xs: torch.Tensor, W: torch.Tensor, cfg: dict) -> torch.Tensor:
    bs = cfg["block_size"]
    out = torch.zeros((Xs_new.shape[0], W.shape[1]), dtype=F64, device=W.device)
    for s in range(0, Xs.shape[0], bs):
        out += kernel(Xs_new, Xs[s:s + bs], cfg["gamma"]) @ W[s:s + bs]
    return out


def reference(cfg: dict, inputs: dict, seed: int, device, wanted: set) -> dict:
    """Every number in ``wanted``: the model's stages and ``scores``: one
    block of scores for each of ``inputs["batches"]`` where the traffic has
    batches, else those of the train and the test set."""
    X = inputs["X_train"]
    filters, whitener, means = learn_filters(X, cfg, seed)
    F = featurize(X, filters, means, cfg)
    mean, std = scaler(F)
    Xs = (F - mean) / std
    del F
    W = krr(Xs, inputs["y_train"], cfg, seed)

    def score(images):
        return scores((featurize(images, filters, means, cfg) - mean) / std, Xs, W, cfg)

    out = {"filters": filters, "whitener": (whitener, means), "scaler": (mean, std),
           "features": Xs, "weights": W}
    if "scores" in wanted and "batches" in inputs:
        out["scores"] = [score(B) for B in inputs["batches"]]
    elif "scores" in wanted:
        out["scores"] = (scores(Xs, Xs, W, cfg), score(inputs["X_test"]))
    return {k: v for k, v in out.items() if k in wanted}
