'''
The string-route inputs of the benchmark suite, written by the port's own
host modules: `sn2_string` (C2H4 + CH3Cl fixtures, noisy conformers) and
`large_n_string` (two synthetic C24H49Cl chains, 148-atom poses). The rng
calls are bench_suite._config_files' (seed 7, then `write_noisy` or
`write_chloroalkane` per molecule), so the files are byte for byte the
suite's.

    config_files('sn2_string', workdir, n_confs=76) -> workdir/input.txt
'''

import os

import numpy as np

from tscode_tpu_torch.io_xyz import read_xyz, write_xyz
from tscode_tpu_torch.pipeline import FIXTURE_DIR

NOISE = 0.12          # A of per-conformer jitter on the fixtures
CONFIGS = ('sn2_string', 'large_n_string')


def write_noisy(src, dst, n_confs, rng, noise=NOISE):
    '''Tile a fixture molecule into n_confs jittered conformers.'''
    data = read_xyz(src)
    base = data.atomcoords[0]
    with open(dst, 'w') as f:
        for c in range(n_confs):
            write_xyz(base + rng.normal(size=base.shape) * noise,
                      data.atomnos, f, title=f'conf {c}')


def chloroalkane(n_carbons):
    '''Idealized zigzag 1-chloroalkane Cl-(CH2)_{n-1}-CH3 as (coords
    (N, 3), atomnos (N,)), built from tetrahedral angles. Atom 0 is the
    Cl-bearing carbon; Cl sits out of the chain's plane, so the sp3
    orbital (anti to Cl) points perpendicular to the chain.'''
    cc, ch, ccl = 1.526, 1.09, 1.79
    alpha = np.deg2rad(35.2644)          # half the 70.53 deg zigzag turn
    u = np.array([[np.cos(alpha), 0.0, np.sin(alpha)],
                  [np.cos(alpha), 0.0, -np.sin(alpha)]])
    y = np.array([0.0, 1.0, 0.0])
    sin_d, cos_d = 0.8165, 0.57735       # tetrahedral H fan components

    backbone = np.zeros((n_carbons, 3))
    for i in range(1, n_carbons):
        backbone[i] = backbone[i - 1] + cc * u[(i - 1) % 2]

    def h_pair(c, d1, d2):
        b = d1 + d2
        b /= np.linalg.norm(b)
        return [c + ch * (-cos_d * b + sin_d * y),
                c + ch * (-cos_d * b - sin_d * y)]

    coords, nos = [], []
    for i, c in enumerate(backbone):
        coords.append(c)
        nos.append(6)
        if i == 0:
            back = -u[1]                 # virtual previous-bond direction
            b = back + u[0]
            b /= np.linalg.norm(b)
            coords.append(c + ccl * (-cos_d * b + sin_d * y))
            nos.append(17)
            coords.append(c + ch * (-cos_d * b - sin_d * y))
            nos.append(1)
            coords.append(c + ch * back)
            nos.append(1)
        elif i < n_carbons - 1:
            coords.extend(h_pair(c, -u[(i - 1) % 2], u[i % 2]))
            nos.extend([1, 1])
        else:                            # terminal CH3
            cont = u[i % 2]
            coords.append(c + ch * cont)
            nos.append(1)
            coords.extend(h_pair(c, -u[(i - 1) % 2], cont))
            nos.extend([1, 1])
    return np.array(coords), np.array(nos)


def write_chloroalkane(dst, n_carbons, n_confs, rng, noise=0.05):
    '''Write n_confs jittered conformers of the synthetic chloroalkane.'''
    coords, nos = chloroalkane(n_carbons)
    with open(dst, 'w') as f:
        for c in range(n_confs):
            write_xyz(coords + rng.normal(size=coords.shape) * noise,
                      nos, f, title=f'conf {c}')


def config_files(name, workdir, n_confs):
    '''Write input.txt and its molecule files for `name` (one of CONFIGS)
    at n_confs conformers per molecule; returns the input file's path.'''
    rng = np.random.default_rng(7)
    j = os.path.join
    if name == 'sn2_string':
        write_noisy(j(FIXTURE_DIR, 'C2H4.xyz'), j(workdir, 'm1.xyz'),
                    n_confs, rng)
        write_noisy(j(FIXTURE_DIR, 'CH3Cl.xyz'), j(workdir, 'm2.xyz'),
                    n_confs, rng)
        content = 'NOOPT\nm1.xyz 0\nm2.xyz 0\n'
    elif name == 'large_n_string':
        # DIST(a=3.2): a van-der-Waals contact docking distance, which
        # passes the anti-anti spin angles (~5% of the grid)
        write_chloroalkane(j(workdir, 'm1.xyz'), 24, n_confs, rng)
        write_chloroalkane(j(workdir, 'm2.xyz'), 24, n_confs, rng)
        content = 'NOOPT DIST(a=3.2)\nm1.xyz 0a\nm2.xyz 0a\n'
    else:
        raise ValueError(f'unknown input {name!r}; one of {CONFIGS}')
    path = j(workdir, 'input.txt')
    with open(path, 'w') as f:
        f.write(content)
    return path
