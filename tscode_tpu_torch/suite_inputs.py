'''
Inputs of the benchmark suite, written by the port's own host modules:
the string routes `sn2_string` (C2H4 + CH3Cl fixtures, noisy conformers)
and `large_n_string` (two synthetic C24H49Cl chains, 148-atom poses),
and the rigid cyclical routes `da_cyclical` and `da_cyclical_xl` (C2H4 +
CH3Cl docked on two pairings, RIGID; the two differ only in the suite's
conformer count), the rigid multi-arrangement route `multiembed`
(HCOOH with three reactive atoms + C2H4 with two, 12 arrangements), and
the non-rigid three-molecule route `trimolecular` (CH3Cl as it is, then
max(2, n_confs // 4) conformers of HCOOH at noise 0.05, listed twice;
no RIGID, so molecules are bent where their pivots close no triangle;
give it four times the HCOOH conformer count wanted). The
rng calls are bench_suite._config_files' (seed 7, then `write_noisy` or
`write_chloroalkane` per molecule), so the files are byte for byte the
suite's at the same conformer count.

Four inputs are the port's own:

`trimolecular_rigid` is the suite's `trimolecular` with RIGID added to
the keyword line, so that it runs the rigid three-molecule embed.

`chelotropic` is
    NOOPT RIGID DIST(A=2.5,B=2.5)
    m1.xyz 0A 3B        (C2H4, n_confs noisy conformers)
    m2.xyz 4AB          (HCOOOH, n_confs noisy conformers)
the reference's chelotropic smoke input with the suite's jitter: the
peroxy oxygen has two lobes, so its molecule has a pivot between them.
(CH3Cl with one reactive atom has a single-lobe orbital, no pivot and so
no candidate, in the JAX package as here.)

`chelotropic_nonrigid` is `chelotropic` without RIGID: the default,
bending form of the same embed.

`monomolecular` is
    NOOPT
    m1.xyz 3 5          (C2F2H4, n_confs conformers at noise 0.05)
one molecule bent until its two reactive carbons' orbitals meet.

`torsion_drive` is the suite's own (its files byte for byte): the
monomolecular input behind a conformer search,
    NOOPT
    csearch> m1.xyz 3 5 (C2F2H4, max(2, n_confs // 4) conformers at 0.05)

`csearch_string` searches a flexible chain before the string embed:
    NOOPT
    m1.xyz 0            (C2H4, sn2_string's file at n_confs conformers)
    csearch> m2.xyz 0   (the idealized C10H21Cl chain, one conformer)
the chain has 8 three-fold rotors in one group, so the search rotates
3^8 = 6,561 candidates with the clash back-off and keeps up to 1,000.

`sn2_string_opt` and `da_cyclical_opt` are `sn2_string` and
`da_cyclical` (their files byte for byte) with NOOPT replaced by
    CALC=XTB FFCALC=XTB FFOPT=ON
so that the candidates go through the optimisation stages: the
force-field pre-optimisation, loose and tight, then the calculator's
loose and tight, each followed by the prunes. On da_cyclical the DIST
letters set target distances the xtb adapter walks toward step by step.

`dihedral_scan` drives a ring torsion of a chlorocycloalkane (the third
argument is the ring's carbon count, not a conformer count):
    SADDLE
    scan> m1.xyz 9 12 15 18   (C3-C4-C5-C6, indices taken around the ring)
The internal force field has no torsion terms and its repulsion starts
inside 0.85 of the summed covalent radii, so a torsion whose side
rotates rigidly (every torsion of the csearch_string chain) scans flat;
a ring torsion moves only its last atom and the ring strains, which
gives the coarse scans peaks, the accurate re-scans sub-peaks and the
dimer (SADDLE) something to refine. `ff_operators_input` writes the
other force-field operators' input on the same ring.

    config_files('sn2_string', workdir, n_confs=76) -> workdir/input.txt
    refine_input('ens.xyz', workdir) -> workdir/input.txt (REFINE)
'''

import os
import shutil

import numpy as np

from tscode_tpu_torch.io_xyz import read_xyz, write_xyz
from tscode_tpu_torch.pipeline import FIXTURE_DIR

NOISE = 0.12          # A of per-conformer jitter on the fixtures
CONFIGS = ('sn2_string', 'large_n_string', 'da_cyclical', 'da_cyclical_xl',
           'multiembed', 'chelotropic', 'chelotropic_nonrigid',
           'trimolecular', 'trimolecular_rigid', 'monomolecular',
           'torsion_drive', 'csearch_string', 'dihedral_scan',
           'sn2_string_opt', 'da_cyclical_opt')
OPT_KEYWORDS = 'CALC=XTB FFCALC=XTB FFOPT=ON'
SEARCH_CHAIN = 10     # carbons of csearch_string's chain


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


def chain_ff(n_atoms, n_confs, seed=0, noise=0.05):
    '''(n_confs jittered conformers (n_confs, n_atoms, 3), the force
    field of their topology (ff.FFParams)) of the zigzag chloroalkane
    cut to its first n_atoms atoms: FIRE on the internal force field at
    sizes no suite input reaches (2,500 atoms: ~3.1M repulsion pairs).'''
    from tscode_tpu_torch.ff import build_ff_params
    from tscode_tpu_torch.graphs import graphize
    coords, nos = chloroalkane(max(2, -(-(n_atoms - 2) // 3)))
    coords, nos = coords[:n_atoms], nos[:n_atoms]
    params = build_ff_params(coords, nos, graphize(coords, nos))
    rng = np.random.default_rng(seed)
    return coords + rng.normal(size=(n_confs,) + coords.shape) * noise, \
        params


def chlorocycloalkane(n_carbons, pucker=0.25):
    '''Crown conformation of chlorocycloalkane C_nH_(2n-1)Cl as (coords
    (N, 3), atomnos (N,)): ring carbons on a circle, alternately
    `pucker` A above and below its plane, 1.526 A apart; two
    substituents per carbon on the bisector plane at tetrahedral angles,
    one of C0's a chlorine. Carbon k is atom 3k, its substituents 3k + 1
    and 3k + 2 (atom 1 the chlorine).'''
    cc, ch, ccl = 1.526, 1.09, 1.79
    radius = np.sqrt(cc ** 2 - (2 * pucker) ** 2) / \
        (2 * np.sin(np.pi / n_carbons))
    phi = 2 * np.pi * np.arange(n_carbons) / n_carbons
    ring = np.stack([radius * np.cos(phi), radius * np.sin(phi),
                     pucker * (-1.0) ** np.arange(n_carbons)], axis=1)
    coords, nos = [], []
    for k, c in enumerate(ring):
        u1 = ring[k - 1] - c
        u2 = ring[(k + 1) % n_carbons] - c
        u1, u2 = u1 / np.linalg.norm(u1), u2 / np.linalg.norm(u2)
        bis = (u1 + u2) / np.linalg.norm(u1 + u2)
        perp = np.cross(u1, u2)
        perp /= np.linalg.norm(perp)
        coords += [c, c + (ccl if k == 0 else ch) *
                   (-0.57735 * bis + 0.8165 * perp),
                   c + ch * (-0.57735 * bis - 0.8165 * perp)]
        nos += [6, 17 if k == 0 else 1, 1]
    return np.array(coords), np.array(nos)


def ring_torsion(n_carbons):
    '''The scanned torsion of `dihedral_scan`: carbons 3 to 6 of the
    ring, counted around it.'''
    return [3 * (k % n_carbons) for k in range(3, 7)]


def ff_operators_input(workdir, n_carbons, start, far, top):
    '''The force-field operators' input beside dihedral_scan's, on the
    same ring, one data operator per molecule line:
        NOOPT
        neb> mneb.xyz       (two conformers: `start` and `far`)
        saddle> msad.xyz    (one conformer: `top`)
        scan> m1.xyz 0 1    (the ring as built; C0-Cl is bonded, so the
                             distance scan separates it)
    returns the input file's path.'''
    j = os.path.join
    coords, nos = chlorocycloalkane(n_carbons)
    for name, frames in (('mneb.xyz', (start, far)), ('msad.xyz', (top,)),
                         ('m1.xyz', (coords,))):
        with open(j(workdir, name), 'w') as f:
            for c, frame in enumerate(frames):
                write_xyz(np.asarray(frame), nos, f, title=f'conf {c}')
    path = j(workdir, 'input.txt')
    with open(path, 'w') as f:
        f.write('NOOPT\nneb> mneb.xyz\nsaddle> msad.xyz\nscan> m1.xyz 0 1\n')
    return path


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
    if name in ('sn2_string_opt', 'da_cyclical_opt'):
        path = config_files(name[:-len('_opt')], workdir, n_confs)
        with open(path) as f:
            content = f.read()
        with open(path, 'w') as f:
            f.write(content.replace('NOOPT', OPT_KEYWORDS, 1))
        return path
    rng = np.random.default_rng(7)
    j = os.path.join
    if name == 'sn2_string':
        write_noisy(j(FIXTURE_DIR, 'C2H4.xyz'), j(workdir, 'm1.xyz'),
                    n_confs, rng)
        write_noisy(j(FIXTURE_DIR, 'CH3Cl.xyz'), j(workdir, 'm2.xyz'),
                    n_confs, rng)
        content = 'NOOPT\nm1.xyz 0\nm2.xyz 0\n'
    elif name in ('da_cyclical', 'da_cyclical_xl'):
        write_noisy(j(FIXTURE_DIR, 'C2H4.xyz'), j(workdir, 'm1.xyz'),
                    n_confs, rng)
        write_noisy(j(FIXTURE_DIR, 'CH3Cl.xyz'), j(workdir, 'm2.xyz'),
                    n_confs, rng)
        content = ('NOOPT RIGID DIST(a=2.2,b=2.3)\n'
                   'm1.xyz 0a 3b\nm2.xyz 0a 4b\n')
    elif name == 'large_n_string':
        # DIST(a=3.2): a van-der-Waals contact docking distance, which
        # passes the anti-anti spin angles (~5% of the grid)
        write_chloroalkane(j(workdir, 'm1.xyz'), 24, n_confs, rng)
        write_chloroalkane(j(workdir, 'm2.xyz'), 24, n_confs, rng)
        content = 'NOOPT DIST(a=3.2)\nm1.xyz 0a\nm2.xyz 0a\n'
    elif name == 'multiembed':
        write_noisy(j(FIXTURE_DIR, 'HCOOH.xyz'), j(workdir, 'm1.xyz'),
                    n_confs, rng)
        write_noisy(j(FIXTURE_DIR, 'C2H4.xyz'), j(workdir, 'm2.xyz'),
                    n_confs, rng)
        content = 'NOOPT RIGID\nm1.xyz 0 1 3\nm2.xyz 0 1\n'
    elif name in ('chelotropic', 'chelotropic_nonrigid'):
        write_noisy(j(FIXTURE_DIR, 'C2H4.xyz'), j(workdir, 'm1.xyz'),
                    n_confs, rng)
        write_noisy(j(FIXTURE_DIR, 'HCOOOH.xyz'), j(workdir, 'm2.xyz'),
                    n_confs, rng)
        rigid = ' RIGID' if name == 'chelotropic' else ''
        content = (f'NOOPT{rigid} DIST(A=2.5,B=2.5)\n'
                   'm1.xyz 0A 3B\nm2.xyz 4AB\n')
    elif name in ('trimolecular', 'trimolecular_rigid'):
        shutil.copy(j(FIXTURE_DIR, 'CH3Cl.xyz'), j(workdir, 'm1.xyz'))
        write_noisy(j(FIXTURE_DIR, 'HCOOH.xyz'), j(workdir, 'm2.xyz'),
                    max(2, n_confs // 4), rng, noise=0.05)
        rigid = ' RIGID' if name == 'trimolecular_rigid' else ''
        content = (f'BYPASS{rigid} DIST(A=2.5,x=2,y=2.5,C=1) SHRINK '
                   'ROTRANGE=10 STEPS=2\nm1.xyz 0A 4y\n'
                   'm2.xyz 1A 4x 0C 2C\nm2.xyz 1x 4y\n')
    elif name == 'monomolecular':
        write_noisy(j(FIXTURE_DIR, 'C2F2H4.xyz'), j(workdir, 'm1.xyz'),
                    n_confs, rng, noise=0.05)
        content = 'NOOPT\nm1.xyz 3 5\n'
    elif name == 'torsion_drive':
        write_noisy(j(FIXTURE_DIR, 'C2F2H4.xyz'), j(workdir, 'm1.xyz'),
                    max(2, n_confs // 4), rng, noise=0.05)
        content = 'NOOPT\ncsearch> m1.xyz 3 5\n'
    elif name == 'csearch_string':
        write_noisy(j(FIXTURE_DIR, 'C2H4.xyz'), j(workdir, 'm1.xyz'),
                    n_confs, rng)
        coords, nos = chloroalkane(SEARCH_CHAIN)
        with open(j(workdir, 'm2.xyz'), 'w') as f:
            write_xyz(coords, nos, f, title='conf 0')
        content = 'NOOPT\nm1.xyz 0\ncsearch> m2.xyz 0\n'
    elif name == 'dihedral_scan':
        coords, nos = chlorocycloalkane(n_confs)
        with open(j(workdir, 'm1.xyz'), 'w') as f:
            write_xyz(coords, nos, f, title='conf 0')
        quad = ' '.join(str(i) for i in ring_torsion(n_confs))
        content = f'SADDLE\nscan> m1.xyz {quad}\n'
    else:
        raise ValueError(f'unknown input {name!r}; one of {CONFIGS}')
    path = j(workdir, 'input.txt')
    with open(path, 'w') as f:
        f.write(content)
    return path


def refine_input(ensemble_path, workdir):
    '''The refine route's input: a copy of the ensemble as
    workdir/ens.xyz beside workdir/input.txt, whose two lines are
    "NOOPT REFINE" and "ens.xyz"; returns the input file's path.'''
    shutil.copy(ensemble_path, os.path.join(workdir, 'ens.xyz'))
    path = os.path.join(workdir, 'input.txt')
    with open(path, 'w') as f:
        f.write('NOOPT REFINE\nens.xyz\n')
    return path
