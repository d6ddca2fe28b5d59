'''The stage counts of the rigid multi-arrangement, chelotropic and
three-molecule routes, of the non-rigid three-molecule route and of the
routes behind a conformer search (csearch>), taken from the JAX package
in float64 on the CPU: the reference counts that chip_smoke.py holds the
port to on the card (its constants ME_*, CHEL_F64, TRI_F64,
BEND_TRI_F64, DRIVE_F64 and SEARCH_F64). For the non-rigid routes also
the bends: how many ran, how many reverted to the unbent molecule and
how many calls the cache answered; for the searches the conformers each
search kept. Both packages draw the search's random numbers from a
generator seeded with 0 (numpy's global one in the JAX package).

csearch_string docks C2H4 on the chlorinated carbon of the searched
chain: the chlorine lies on the reactive axis, so the torsion
quadruplets that end on it are collinear and their dihedrals are
rounding noise, as on large_n_string (ROADMAP.md section 3). For it the
record also holds the clash survivors, those quadruplets and the
novelty replay of the survivors without them (`replay`), which both
packages must give exactly; its novel and final counts agree within
10%.

The force-field routes are recorded the same way (`ff_counts`, both
packages, through tscode_tpu_torch.ff_records, which chip_smoke.py runs
on the card): `dihedral_scan`
(the SADDLE dihedral scan of a chlorocycloalkane ring, its third argument
the ring's carbons) gives every sweep's points, the peaks and sub-peaks,
each dimer's flag and the surviving maxima, with the imaginary-mode
count of every refined maximum; `ff_operators` (neb>, saddle> and a
distance scan on the same ring, their inputs taken from the JAX run of
the dihedral scan: its first clockwise point, the point 120 degrees on,
the highest) gives the band's TS image, the dimer's flag and the
distance scan's points and peak.

The optimising routes are recorded the same way (`opt_counts`, both
packages, through tscode_tpu_torch.opt_records, which chip_smoke.py runs
on the card): `sn2_string_opt` (sn2_string without NOOPT, the
calculators chosen by keyword, every calculator call answered by the
stand-in xtb of tests/torch_standin, run as an executable first on
PATH) gives every refine stage's energies and exit status, every
prune's counts, the final frames and energies, the rows of the final
poses file and the number of stand-in calls.

As a script it prints the JAX package's counts and seconds of one suite
input (written by tscode_tpu_torch.suite_inputs.config_files) as JSON,
and with a third argument also saves the searched conformers (an .npz
of `frames`, every search's output in order, and `sizes`), or for the
force-field routes every array of the record and, as JSON text under
`record`, its counts:

    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py multiembed 41
    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py chelotropic 62
    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py trimolecular_rigid 256
    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py trimolecular 64
    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py torsion_drive 8
    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py csearch_string 16 \
        tests/golden/csearch_string_search.npz
    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py dihedral_scan 8 \
        tests/golden/dihedral_scan.npz
    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py ff_operators 8 \
        tests/golden/ff_operators.npz
    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py sn2_string_opt 76 \
        tests/golden/sn2_string_opt.npz

As a test it takes the same counts at a few conformers from both
packages and demands that they are equal.'''

import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from tscode_tpu_torch import ff_records, opt_records  # noqa: E402


def stage_list(report):
    return [[s['stage'], s['structures_in'], s['structures_out']]
            for s in report['stages']]


def jax_counts(name, n_confs, workdir):
    '''Run the JAX package (float64, CPU) on the suite input `name` at
    n_confs conformers in workdir. Returns a dict: candidates, seconds,
    stages [[stage, in, out], ...], final; for multiembed also children
    [[block rows, sweep survivors, structures], ...] in arrangement
    order; for the rigid three-molecule embed also blocks and
    embed_candidates; for the non-rigid one also bends, bend_reverts
    and bend_hits.'''
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import tscode_tpu.bending as jb
    import tscode_tpu.embeds.common as jcommon
    import tscode_tpu.embeds.cyclical as jc
    import tscode_tpu.embeds.monomolecular as jmono
    import tscode_tpu.multiembed as jm
    import tscode_tpu.torsions as jt
    from tscode_tpu.embedder import Embedder
    from tscode_tpu_torch.suite_inputs import config_files

    rec = {'name': name, 'n_confs': n_confs, 'children': []}
    build, finish, trimol = (jm._build_child, jm._finish_child,
                             jc.cyclical_embed_trimol_rigid)
    bend, search = jb.bend_molecule, jt.csearch
    if name in BENDING:
        rec.update(bends=0, bend_reverts=0, bend_hits=0)
    if name in SEARCHING:
        rec.update(searched=[], frames=[])
    survivors = []

    class Survivors(jcommon.MaskedPullAccumulator):
        def finish(self):
            out = super().finish()
            survivors.append([np.asarray(f) for f in out[0]])
            return out

    def spy_search(*args, **kw):
        out = search(*args, **kw)
        rec['searched'].append(len(out))
        rec['frames'].append(np.asarray(out))
        return out

    def spy_bend(mol, conf, pivot, threshold, **kw):
        hit = jb.bend_key(mol, pivot, threshold, conf=conf) in kw['cache']
        out = bend(mol, conf, pivot, threshold, **kw)
        rec['bend_hits'] += hit
        rec['bends'] += not hit
        rec['bend_reverts'] += not hit and out is mol
        return out

    def spy_build(parent, arrangement, i):
        out = build(parent, arrangement, i)
        rec['children'].append([0 if out[2] is None else len(out[2]['c1'])])
        return out

    def spy_finish(parent, run, folder, pre):
        structures, cons = finish(parent, run, folder, pre)
        i = int(folder.replace('tscode_embed', '')) - 1
        rec['children'][i] += [len(pre[0]), len(structures)]
        return structures, cons

    def spy_trimol(*args, **kw):
        log = kw.get('log', print)

        def keep(line):
            # "... (C candidates, B blocks)"
            if 'blocks)' in line:
                c, b = line[line.index('(') + 1:line.index(')')].split(', ')
                rec['embed_candidates'] = int(c.split()[0])
                rec['blocks'] = int(b.split()[0])
            log(line)
        kw['log'] = keep
        return trimol(*args, **kw)

    inp = config_files(name, workdir, n_confs)
    cwd = os.getcwd()
    jm._build_child, jm._finish_child = spy_build, spy_finish
    jc.cyclical_embed_trimol_rigid = spy_trimol
    jb.bend_molecule = jmono.bend_molecule = spy_bend
    jt.csearch = spy_search
    accumulator = jcommon.MaskedPullAccumulator
    jcommon.MaskedPullAccumulator = Survivors
    np.random.seed(0)
    t0 = time.perf_counter()
    try:
        emb = Embedder(inp, stamp='jax')
        rec['candidates'] = int(emb.candidates)
        run = emb.run()
    finally:
        os.chdir(cwd)
        jm._build_child, jm._finish_child = build, finish
        jc.cyclical_embed_trimol_rigid = trimol
        jb.bend_molecule = jmono.bend_molecule = bend
        jt.csearch = search
        jcommon.MaskedPullAccumulator = accumulator
    rec['seconds'] = time.perf_counter() - t0
    with open(os.path.join(workdir, 'tscode_report_jax.json')) as f:
        rec['stages'] = stage_list(json.load(f))
    rec['final'] = len(run.structures)
    # an arrangement without survivors is never finished
    rec['children'] = [c if len(c) == 3 else c + [0, 0]
                       for c in rec['children']]
    if name in STRING:
        from tscode_tpu.graphs import get_quadruplets, get_sum_graph
        from tscode_tpu.ops.tfd import (is_new_structure_lru,
                                        torsion_fingerprints)
        (poses, _), = survivors
        rec.update(string_replay(
            poses, emb.objects, get_quadruplets, get_sum_graph,
            lambda x, q: np.asarray(torsion_fingerprints(x, q)),
            is_new_structure_lru))
    return rec


def string_replay(poses, mols, get_quadruplets, get_sum_graph,
                  fingerprints, is_new_structure_lru):
    """The string embed's clash survivors `poses` (numpy) of the two
    molecules `mols`: their count, the quadruplets with an end angle of
    180 degrees in some survivor (end sine <= 1e-8) and the novelty
    replay without them, with the given package's functions
    (fingerprints: poses, quadruplets -> numpy)."""
    m1, m2 = mols
    quads = np.asarray(get_quadruplets(get_sum_graph(
        (m1.graph, m2.graph), [[int(m1.reactive_indices[0]),
                                int(m2.reactive_indices[0]) + m1.n_atoms]])))
    p = poses[:, quads]

    def sine(u, v):
        return np.linalg.norm(np.cross(u, v), axis=-1) / (
            np.linalg.norm(u, axis=-1) * np.linalg.norm(v, axis=-1))

    b, c = p[..., 1, :], p[..., 2, :]
    ends = np.minimum(sine(p[..., 0, :] - b, c - b),
                      sine(b - c, p[..., 3, :] - c))
    col = (ends <= 1e-8).any(axis=0)
    fps = np.ascontiguousarray(fingerprints(poses, quads[~col]))
    novel = is_new_structure_lru(fps, np.ones(len(fps), dtype=bool),
                                 thresh=10)
    return {'clash_ok': len(poses), 'collinear': quads[col].tolist(),
            'replay': int(np.sum(novel))}


def port_counts(name, n_confs, workdir):
    '''The same record from the port (float64, CPU), read from its run
    report.'''
    import torch
    from tscode_tpu_torch import torsions
    from tscode_tpu_torch.embedder import Embedder
    from tscode_tpu_torch.embeds import string
    from tscode_tpu_torch.suite_inputs import config_files
    inp = config_files(name, workdir, n_confs)
    cwd = os.getcwd()
    search, frames = torsions.csearch, []

    def spy_search(*args, **kw):
        out = search(*args, **kw)
        frames.append(np.asarray(out))
        return out

    torsions.csearch = spy_search
    survivors = []

    class Survivors(string.DeviceSurvivors):
        def finish(self):
            out = super().finish()
            survivors.append(out[0][0])
            return out

    string.DeviceSurvivors = Survivors
    try:
        emb = Embedder(inp, stamp='port', device='cpu', dtype=torch.float64,
                       rng=np.random.RandomState(0))
        rec = {'name': name, 'n_confs': n_confs,
               'candidates': int(emb.candidates)}
        run = emb.run()
    finally:
        os.chdir(cwd)
        torsions.csearch = search
        string.DeviceSurvivors = Survivors.__base__
    with open(os.path.join(workdir, 'tscode_report_port.json')) as f:
        report = json.load(f)
    rec['stages'] = stage_list(report)
    rec['final'] = len(run.structures)
    rec['children'] = [[c['blocks'], c['survivors'], c['structures']]
                       for c in report.get('multiembed_embed',
                                           {}).get('children', [])]
    if name == 'trimolecular_rigid':
        ce = report['cyclical_embed']
        rec['blocks'], rec['embed_candidates'] = ce['blocks'], ce['candidates']
    if name in BENDING:
        ce = report[BENDING[name]]
        rec.update(bends=ce['bends'], bend_reverts=ce['bend_reverts'],
                   bend_hits=ce['bend_hits'])
    if name in SEARCHING:
        rec['searched'] = [s['conformers'] for s in report['csearch']]
        rec['frames'] = frames
    if name in STRING:
        from tscode_tpu_torch.graphs import get_quadruplets, get_sum_graph
        from tscode_tpu_torch.ops.tfd import (is_new_structure_lru,
                                              torsion_fingerprints)
        poses, = survivors
        rec.update(string_replay(
            poses.numpy(), emb.objects, get_quadruplets, get_sum_graph,
            lambda x, q: torsion_fingerprints(torch.as_tensor(x), q).numpy(),
            is_new_structure_lru))
    return rec


# the non-rigid inputs (the run report's record of their bends) and the
# inputs behind a conformer search
BENDING = {'trimolecular': 'cyclical_embed',
           'torsion_drive': 'monomolecular_embed'}
SEARCHING = ('torsion_drive', 'csearch_string')
STRING = ('csearch_string',)
STRING_SLACK = 0.10     # novel and final counts with a collinear quadruplet


@pytest.mark.parametrize('name,n_confs', [('multiembed', 5),
                                          ('chelotropic', 3),
                                          ('trimolecular_rigid', 16),
                                          ('trimolecular', 8),
                                          ('torsion_drive', 8),
                                          ('csearch_string', 2)])
def test_port_counts_equal_the_jax_package(tmp_path, name, n_confs):
    '''Every count this file's script reports is the same from both
    packages at a few conformers, the searched conformers are the JAX
    package's frame for frame (1e-6 A), and the run is not an empty
    one.'''
    import torch_parity  # noqa: F401  (single-threaded torch in this worker)
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    want = jax_counts(name, n_confs, str(tmp_path / 'jax'))
    got = port_counts(name, n_confs, str(tmp_path / 'port'))
    want.pop('seconds')
    if name in SEARCHING:
        for a, b in zip(got.pop('frames'), want.pop('frames'), strict=True):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert all(n > 1 for n in want['searched'])
    if want.get('collinear'):
        # the counts that rest on a collinear quadruplet's dihedral:
        # every stage's output and the final count, within the slack
        assert want['replay'] > 0
        for a, b in zip(got['stages'], want['stages'], strict=True):
            assert a[0] == b[0]
            assert abs(a[2] - b[2]) <= STRING_SLACK * b[2]
        assert abs(got['final'] - want['final']) <= \
            STRING_SLACK * want['final']
        got = dict(got, stages=want['stages'], final=want['final'])
    assert got == want
    assert want['final'] > 0 and want['stages'][0][2] >= want['final']
    if name == 'multiembed':
        assert len(want['children']) == 12
        assert sum(c[2] for c in want['children']) == want['stages'][0][2]
    if name == 'trimolecular_rigid':
        assert want['blocks'] > 0
    if name in BENDING:
        assert want['bends'] > 0


def ff_counts(pkg, name, n_carbons, workdir, scan=None, device='cpu'):
    '''tscode_tpu_torch.ff_records.record of one force-field route of
    `pkg`: 'jax', the JAX package in float64 on the CPU, or 'port', float64
    on `device`.'''
    if pkg == 'port':
        package = ff_records.port_package(device)
    else:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        jax.config.update('jax_enable_x64', True)
        from tscode_tpu import ff, neb, saddle, scans, vibrations
        from tscode_tpu.embedder import Embedder

        def frequencies(x, atomnos, graph, guess):
            params = ff.params_to_device(ff.build_ff_params(guess, atomnos,
                                                            graph))
            return vibrations.frequencies(
                x, atomnos, lambda c: ff.ff_energy(c[None], params)[0])

        package = ff_records.Package(neb, saddle, scans, Embedder, {}, 'jax',
                                     frequencies)
    return ff_records.record(package, name, n_carbons, workdir, scan)


same_ff_records = ff_records.same_records


def jax_opt_package():
    '''opt_records.Package over the JAX package (float64, CPU).'''
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from tscode_tpu import rot_rmsd
    from tscode_tpu.calculators import (dispatch, gaussian, gradients, mopac,
                                        orca, xtb)
    from tscode_tpu.embedder import Embedder
    from tscode_tpu.ops import moi, rmsd_prune, tfd
    return opt_records.Package(
        dispatch, (xtb, gradients, orca, gaussian, mopac), Embedder, {},
        'jax', [(tfd, 'prune_conformers_tfd', 'tfd'),
                (moi, 'prune_by_moment_of_inertia', 'moi'),
                (rmsd_prune, 'prune_conformers_rmsd', 'rmsd'),
                (rot_rmsd, 'prune_conformers_rmsd_rot_corr',
                 'rmsd_rot_corr')])


def opt_counts(pkg, name, n_confs, workdir, device='cpu', **kw):
    '''tscode_tpu_torch.opt_records.record of one optimising route of
    `pkg`: 'jax', the JAX package in float64 on the CPU, or 'port',
    float64 on `device`; kw go to record (standin, keywords, programs).'''
    package = jax_opt_package() if pkg == 'jax' else \
        opt_records.port_package(device)
    return opt_records.record(package, name, n_confs, workdir, **kw)


if __name__ == '__main__':
    name, n_confs = sys.argv[1], int(sys.argv[2])
    with tempfile.TemporaryDirectory(prefix='suite_counts_') as d:
        if name in ('sn2_string_opt', 'da_cyclical_opt'):
            # the stand-in xtb as an executable, first on PATH
            rec = opt_counts('jax', name, n_confs, d, standin='path')
            arrays = rec.pop('arrays')
            for key in ('times', 'pools'):
                rec.pop(key)
            if len(sys.argv) > 3:
                np.savez_compressed(sys.argv[3], record=json.dumps(rec),
                                    **arrays)
        elif name in ('dihedral_scan', 'ff_operators'):
            rec = ff_counts('jax', 'dihedral_scan', n_confs, d)
            if name == 'ff_operators':
                os.mkdir(os.path.join(d, 'ops'))
                rec = ff_counts('jax', name, n_confs,
                                os.path.join(d, 'ops'), scan=rec)
            arrays = rec.pop('arrays')
            rec.pop('times')
            if len(sys.argv) > 3:
                # the counts ride along as JSON text under `record`
                np.savez_compressed(sys.argv[3], record=json.dumps(rec),
                                    **arrays)
        else:
            rec = jax_counts(name, n_confs, d)
            frames = rec.pop('frames', [])
            if len(sys.argv) > 3:
                np.savez_compressed(
                    sys.argv[3], frames=np.concatenate(frames),
                    sizes=np.array([len(f) for f in frames]))
    print(json.dumps(rec))
