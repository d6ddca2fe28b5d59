'''The stage counts of the rigid multi-arrangement, chelotropic and
three-molecule routes and of the non-rigid three-molecule route, taken
from the JAX package in float64 on the CPU: the reference counts that
chip_smoke.py holds the port to on the card (its constants ME_*,
CHEL_F64, TRI_F64 and BEND_TRI_F64). For the non-rigid route also the
bends: how many ran, how many reverted to the unbent molecule and how
many calls the cache answered.

As a script it prints the JAX package's counts and seconds of one suite
input (written by tscode_tpu_torch.suite_inputs.config_files) as JSON:

    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py multiembed 41
    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py chelotropic 62
    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py trimolecular_rigid 256
    JAX_PLATFORMS=cpu python tests/test_torch_suite_counts.py trimolecular 64

As a test it takes the same counts at a few conformers from both
packages and demands that they are equal.'''

import json
import os
import sys
import tempfile
import time

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


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
    import tscode_tpu.embeds.cyclical as jc
    import tscode_tpu.multiembed as jm
    from tscode_tpu.embedder import Embedder
    from tscode_tpu_torch.suite_inputs import config_files

    rec = {'name': name, 'n_confs': n_confs, 'children': []}
    build, finish, trimol = (jm._build_child, jm._finish_child,
                             jc.cyclical_embed_trimol_rigid)
    bend = jb.bend_molecule
    if name == 'trimolecular':
        rec.update(bends=0, bend_reverts=0, bend_hits=0)

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
    jb.bend_molecule = spy_bend
    t0 = time.perf_counter()
    try:
        emb = Embedder(inp, stamp='jax')
        rec['candidates'] = int(emb.candidates)
        run = emb.run()
    finally:
        os.chdir(cwd)
        jm._build_child, jm._finish_child = build, finish
        jc.cyclical_embed_trimol_rigid = trimol
        jb.bend_molecule = bend
    rec['seconds'] = time.perf_counter() - t0
    with open(os.path.join(workdir, 'tscode_report_jax.json')) as f:
        rec['stages'] = stage_list(json.load(f))
    rec['final'] = len(run.structures)
    # an arrangement without survivors is never finished
    rec['children'] = [c if len(c) == 3 else c + [0, 0]
                       for c in rec['children']]
    return rec


def port_counts(name, n_confs, workdir):
    '''The same record from the port (float64, CPU), read from its run
    report.'''
    import torch
    from tscode_tpu_torch.embedder import Embedder
    from tscode_tpu_torch.suite_inputs import config_files
    inp = config_files(name, workdir, n_confs)
    cwd = os.getcwd()
    try:
        emb = Embedder(inp, stamp='port', device='cpu', dtype=torch.float64)
        rec = {'name': name, 'n_confs': n_confs,
               'candidates': int(emb.candidates)}
        run = emb.run()
    finally:
        os.chdir(cwd)
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
    if name == 'trimolecular':
        ce = report['cyclical_embed']
        rec.update(bends=ce['bends'], bend_reverts=ce['bend_reverts'],
                   bend_hits=ce['bend_hits'])
    return rec


@pytest.mark.parametrize('name,n_confs', [('multiembed', 5),
                                          ('chelotropic', 3),
                                          ('trimolecular_rigid', 16),
                                          ('trimolecular', 8)])
def test_port_counts_equal_the_jax_package(tmp_path, name, n_confs):
    '''Every count this file's script reports is the same from both
    packages at a few conformers, and the run is not an empty one.'''
    import torch_parity  # noqa: F401  (single-threaded torch in this worker)
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    want = jax_counts(name, n_confs, str(tmp_path / 'jax'))
    got = port_counts(name, n_confs, str(tmp_path / 'port'))
    want.pop('seconds')
    assert got == want
    assert want['final'] > 0 and want['stages'][0][2] >= want['final']
    if name == 'multiembed':
        assert len(want['children']) == 12
        assert sum(c[2] for c in want['children']) == want['stages'][0][2]
    if name == 'trimolecular_rigid':
        assert want['blocks'] > 0
    if name == 'trimolecular':
        assert want['bends'] > 0


if __name__ == '__main__':
    with tempfile.TemporaryDirectory(prefix='suite_counts_') as d:
        print(json.dumps(jax_counts(sys.argv[1], int(sys.argv[2]), d)))
