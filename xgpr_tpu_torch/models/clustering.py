"""Approximate kernel PCA and kernel k-means on random features (port of
xgpr_tpu/models/clustering.py): with random features z(x), kernel PCA is
PCA of z and kernel k-means is k-means in z space.  The features come
from ``AuxiliaryBaseclass``'s kernel on its device (K2 or K3 on the card).

- ``KernelPCA.fit`` sums Z^T Z and the column sums over chunks with
  float64 products on the device, as the engine does for the design
  matrix, then takes ``torch.linalg.eigh`` of the float64 covariance
  there.  ``components_``, ``mean_`` and ``explained_variance_`` are
  float64 tensors on the device; ``transform`` returns numpy.
- ``KernelKMeans.fit`` seeds k-means++ style from a numpy
  ``default_rng(random_seed)``, with xgpr_tpu's draws, then runs Lloyd
  steps as tensor ops on the device until the centres move less than
  ``tol`` (summed squared shift) or ``max_iter`` steps.  ``labels_`` are
  the last step's assignments, ``cluster_centers_`` a tensor on the
  device.
"""
import numpy as np
import torch

from .kernel_fgen import AuxiliaryBaseclass
from ..ops.contract import mm


class KernelPCA(AuxiliaryBaseclass):
    """Approximate kernel PCA via random features."""

    def __init__(self, n_components, num_rffs, hyperparams, num_features,
                 kernel_choice="RBF", device="cuda", kernel_settings=None,
                 random_seed=123, verbose=True):
        super().__init__(num_rffs, hyperparams, num_features,
                         kernel_choice, device, kernel_settings,
                         random_seed, verbose)
        self.n_components = int(n_components)
        self.mean_ = None
        self.components_ = None
        self.explained_variance_ = None

    def fit(self, input_x, sequence_lengths=None, chunk_size=2000):
        """Covariance of the features (float64 on the device) and its
        leading eigenvectors."""
        m = self.kernel.get_num_rffs()
        cov = torch.zeros((m, m), dtype=torch.float64, device=self.device)
        mean = torch.zeros((m,), dtype=torch.float64, device=self.device)
        for z in self._chunked_features(input_x, sequence_lengths,
                                        chunk_size):
            z = z.double()
            cov += mm(z.T, z)
            mean += z.sum(dim=0)
        n = input_x.shape[0]
        mean = mean / n
        cov = cov / n - torch.outer(mean, mean)
        eigvals, eigvecs = torch.linalg.eigh(cov)
        # eigh sorts ascending: the reversed order is xgpr_tpu's
        # argsort(eigvals)[::-1].
        order = torch.flip(torch.arange(m, device=self.device),
                           dims=[0])[:self.n_components]
        self.mean_ = mean
        self.components_ = eigvecs[:, order].T
        self.explained_variance_ = eigvals[order]
        return self

    def transform(self, input_x, sequence_lengths=None, chunk_size=2000):
        """The rows' coordinates on the components, (N, n_components)
        float64 numpy."""
        if self.components_ is None:
            raise RuntimeError("KernelPCA has not been fitted yet.")
        return np.vstack([
            ((z.double() - self.mean_[None, :]) @ self.components_.T)
            .cpu().numpy()
            for z in self._chunked_features(input_x, sequence_lengths,
                                            chunk_size)])

    def fit_transform(self, input_x, sequence_lengths=None,
                      chunk_size=2000):
        self.fit(input_x, sequence_lengths, chunk_size)
        return self.transform(input_x, sequence_lengths, chunk_size)


def _sq_dists(z, z_sq, centers):
    """(N, k) squared distances of the rows of z (with their squared norms
    z_sq (N, 1)) to the centres."""
    return z_sq - 2 * mm(z, centers.T) + torch.sum(centers ** 2,
                                                   dim=1)[None, :]


class KernelKMeans(AuxiliaryBaseclass):
    """Approximate kernel k-means: Lloyd's algorithm in feature space."""

    def __init__(self, n_clusters, num_rffs, hyperparams, num_features,
                 kernel_choice="RBF", device="cuda", kernel_settings=None,
                 random_seed=123, verbose=True, max_iter=100, tol=1e-5):
        super().__init__(num_rffs, hyperparams, num_features,
                         kernel_choice, device, kernel_settings,
                         random_seed, verbose)
        self.n_clusters = int(n_clusters)
        self.max_iter = max_iter
        self.tol = tol
        self.random_seed = random_seed
        self.cluster_centers_ = None
        self.labels_ = None

    def fit(self, input_x, sequence_lengths=None, chunk_size=2000):
        z = torch.cat(list(self._chunked_features(input_x, sequence_lengths,
                                                  chunk_size)))
        n = z.shape[0]

        # k-means++ style seeding, the draws on the host.
        rng = np.random.default_rng(self.random_seed)
        centers = [z[int(rng.integers(0, n))]]
        d2 = None
        for _ in range(self.n_clusters - 1):
            dist = torch.sum((z - centers[-1][None, :]) ** 2, dim=1)
            d2 = dist if d2 is None else torch.minimum(d2, dist)
            probs = d2.cpu().numpy().astype(np.float64)
            probs = probs / probs.sum()
            centers.append(z[int(rng.choice(n, p=probs))])
        centers = torch.stack(centers)

        z_sq = torch.sum(z ** 2, dim=1, keepdim=True)
        for _ in range(self.max_iter):
            assign = torch.argmin(_sq_dists(z, z_sq, centers), dim=1)
            onehot = torch.nn.functional.one_hot(
                assign, self.n_clusters).to(z.dtype)
            counts = onehot.sum(dim=0)
            sums = mm(onehot.T, z)
            new_centers = sums / torch.clamp(counts, min=1.0)[:, None]
            new_centers = torch.where(counts[:, None] > 0, new_centers,
                                      centers)
            shift = float(torch.sum((new_centers - centers) ** 2))
            centers = new_centers
            if shift < self.tol:
                break
        self.cluster_centers_ = centers
        self.labels_ = assign.cpu().numpy()
        return self

    def predict(self, input_x, sequence_lengths=None, chunk_size=2000):
        """The nearest centre of each row, as a numpy int array."""
        if self.cluster_centers_ is None:
            raise RuntimeError("KernelKMeans has not been fitted yet.")
        c = self.cluster_centers_
        return np.concatenate([
            torch.argmin(_sq_dists(z, torch.sum(z ** 2, dim=1, keepdim=True),
                                   c), dim=1).cpu().numpy()
            for z in self._chunked_features(input_x, sequence_lengths,
                                            chunk_size)])
