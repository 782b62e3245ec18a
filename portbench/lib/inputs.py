"""Inputs made from a run's seed: planted latents for the clustering jobs,
and planted contigs' TNF, abundance and lengths for VAE training.

Every seed gets the same work: the same genome sizes, noise share and set
of contig lengths, in an order and around centres that the seed draws. So
seeds differ in where points lie, not in how much there is to cluster or
train. The draws run on the device with a `torch.Generator` seeded by the
run's seed, in a few large calls; the arrays then go to the host, as the
program takes its inputs from numpy.
"""

import math

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def genome_sizes(n_points: int, n_genomes: int, sigma: float) -> np.ndarray:
    """Contigs a genome: lognormal in shape (the quantiles of exp(sigma Z)
    at the genomes' mid-ranks), at least one each, summing to `n_points`
    (largest remainders). The same for every seed."""
    q = (np.arange(n_genomes) + 0.5) / n_genomes
    z = np.array([math.sqrt(2.0) * _erfinv(2.0 * p - 1.0) for p in q])
    w = np.exp(sigma * z)
    raw = 1 + w / w.sum() * (n_points - n_genomes)
    sizes = np.floor(raw).astype(np.int64)
    short = n_points - sizes.sum()
    sizes[np.argsort(-(raw - sizes), kind="stable")[:short]] += 1
    return sizes


def _erfinv(y: float) -> float:
    return float(torch.special.erfinv(torch.tensor(y, dtype=torch.float64)))


def contig_lengths(n: int, lo: int, hi: int, g: torch.Generator, device) -> np.ndarray:
    "A fixed, evenly spread set of lengths in [lo, hi], in the seed's order, float32."
    fixed = lo + (torch.arange(n, device=device, dtype=torch.float64) * (hi - lo) / max(1, n - 1))
    perm = torch.randperm(n, generator=g, device=device)
    return fixed.round()[perm].float().cpu().numpy()


def planted_labels(n: int, n_genomes: int, noise_frac: float, size_sigma: float,
                   g: torch.Generator, device) -> torch.Tensor:
    """Each point's genome, -1 for the unstructured share `noise_frac`,
    in the seed's order."""
    n_noise = round(noise_frac * n)
    sizes = torch.as_tensor(genome_sizes(n - n_noise, n_genomes, size_sigma), device=device)
    labels = torch.cat([torch.repeat_interleave(torch.arange(n_genomes, device=device), sizes),
                        torch.full((n_noise,), -1, device=device, dtype=torch.int64)])
    return labels[torch.randperm(n, generator=g, device=device)]


def planted_latent(n: int, width: int, traffic: dict, seed: int, device):
    """(n, width) float32 latent and (n,) float32 lengths: genomes as
    clumps around unit centres, and an unstructured share of points in
    random directions. Genomes come as strains of species (`strains` a
    species): a strain's centre is off its species' by noise of norm
    `strain_spread`, so sibling strains lie near each other and a
    cluster's radius falls among points, as in a trained latent. Each
    point is off its genome's centre by noise of norm `spread` x
    lognormal(0, `spread_sigma`)."""
    g = generator(seed, device)
    genomes = traffic["genomes"]
    labels = planted_labels(n, genomes, traffic["noise_frac"], traffic["size_sigma"], g, device)
    species = torch.randn(-(-genomes // traffic["strains"]), width, generator=g, device=device)
    species /= species.norm(dim=1, keepdim=True)
    centers = species[torch.arange(genomes, device=device) // traffic["strains"]]
    centers = centers + traffic["strain_spread"] / math.sqrt(width) * torch.randn(
        genomes, width, generator=g, device=device)
    centers /= centers.norm(dim=1, keepdim=True)
    scale = traffic["spread"] * torch.exp(
        traffic["spread_sigma"] * torch.randn(n, generator=g, device=device)) / math.sqrt(width)
    x = torch.randn(n, width, generator=g, device=device) * scale[:, None]
    planted = labels >= 0
    x[planted] += centers[labels[planted]]
    x[~planted] = torch.randn(int((~planted).sum()), width, generator=g, device=device)
    lengths = contig_lengths(n, traffic["min_length"], traffic["max_length"], g, device)
    return x.cpu().numpy(), lengths


def planted_contigs(n: int, nsamples: int, ntnf: int, traffic: dict, seed: int, device):
    """Raw training inputs for `n` contigs: (n, nsamples) depths, (n, ntnf)
    TNF and (n,) lengths, float32. A genome has a TNF profile and a depth
    in each sample (lognormal); a contig is its genome's, with noise."""
    g = generator(seed, device)
    genomes = traffic["genomes"]
    labels = planted_labels(n, genomes, traffic["noise_frac"], traffic["size_sigma"], g, device)
    labels = torch.where(labels >= 0, labels,
                         torch.randint(0, genomes, (n,), generator=g, device=device))
    tnf_profile = torch.randn(genomes, ntnf, generator=g, device=device)
    depth = torch.exp(traffic["depth_sigma"] * torch.randn(genomes, nsamples, generator=g,
                                                           device=device))
    tnf = tnf_profile[labels] + traffic["tnf_noise"] * torch.randn(n, ntnf, generator=g,
                                                                   device=device)
    ab = depth[labels] * torch.exp(traffic["depth_noise"] * torch.randn(n, nsamples, generator=g,
                                                                        device=device))
    lengths = contig_lengths(n, traffic["min_length"], traffic["max_length"], g, device)
    return ab.float().cpu().numpy(), tnf.float().cpu().numpy(), lengths
