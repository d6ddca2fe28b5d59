'''The CLI's --trace on the CPU, float64: the port's traced run against
its untraced run and against the JAX package's traced run of the same
input (the written .xyz within 1e-6 A, the same stage counts), the
spans the trace holds (each timed stage, the prunes, the string route's
novelty lane, the search's back-off and TFD prune), and the span
helper, inert with no trace running.'''

import contextlib
import functools
import glob
import io
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from tscode_tpu.__main__ import main as jax_main
from tscode_tpu_torch import backend
from tscode_tpu_torch.__main__ import main
from tscode_tpu_torch.embeds import string
from tscode_tpu_torch.ops import rmsd_prune, tfd
from tscode_tpu_torch.suite_inputs import config_files, refine_input

from test_torch_embedder import assert_same_run, frames, sn2_input


def cli(inp, stamp, *args, entry=main):
    '''One in-process CLI run on inp, its log kept quiet; the working
    directory restored afterwards. Returns the report (None for a run
    that writes none).'''
    cwd = os.getcwd()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert entry([str(inp), '-n', stamp, *args]) == 0
    finally:
        os.chdir(cwd)
    report = os.path.join(os.path.dirname(inp),
                          f'tscode_report_{stamp}.json')
    if not os.path.exists(report):
        return None
    with open(report) as f:
        return json.load(f)


def trace_file(trace_dir):
    paths = glob.glob(os.path.join(trace_dir, '*.pt.trace.json'))
    assert len(paths) == 1, paths
    return paths[0]


def span_counts(trace_dir):
    '''Spans of the trace in trace_dir, by name.'''
    with open(trace_file(trace_dir)) as f:
        events = json.load(f)['traceEvents']
    return Counter(e['name'] for e in events
                   if e.get('cat') == 'user_annotation')


def stages(report):
    return [(s['stage'], s['structures_in'], s['structures_out'])
            for s in report['stages']]


def test_traced_run_equals_untraced(tmp_path):
    sn2_input(tmp_path)
    inp = tmp_path / 'input.txt'
    plain = cli(inp, 'plain', '--device', 'cpu')
    traced = cli(inp, 'traced', '--device', 'cpu', '--trace',
                 str(tmp_path / 'trace'))
    assert stages(traced) == stages(plain)
    assert traced['final_structures'] == plain['final_structures'] == 55
    for tag in ('embedded', 'unoptimized'):
        assert np.array_equal(frames(tmp_path, tag, 'traced'),
                              frames(tmp_path, tag, 'plain'))
    trace_file(tmp_path / 'trace')
    assert not backend._TRACING


def test_trace_matches_the_jax_packages_trace(tmp_path):
    sn2_input(tmp_path)
    inp = tmp_path / 'input.txt'
    rep_j = cli(inp, 'jax', '--trace', str(tmp_path / 'jax_trace'),
                entry=jax_main)
    rep_t = cli(inp, 'port', '--device', 'cpu', '--trace',
                str(tmp_path / 'port_trace'))
    assert_same_run(tmp_path, 'jax', 'port', rep_j, rep_t)
    assert glob.glob(str(tmp_path / 'jax_trace' / 'plugins' / 'profile' /
                         '*' / '*.trace.json.gz'))
    trace_file(tmp_path / 'port_trace')


def counted(calls, name, fn):
    @functools.wraps(fn)
    def spy(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)
    return spy


def test_trace_spans_stages_prunes_and_search(tmp_path, monkeypatch):
    '''The string route with the device novelty lane, REFINE on its
    output and a conformer search alone: a span for every timed stage of
    each run report, and one for each call of the prunes, the novelty
    lane and the TFD prune's successor search the route makes.'''
    calls = Counter()
    for mod, name in ((rmsd_prune, 'prune_conformers_rmsd_device'),
                      (string, 'tfd_novelty_device'),
                      (tfd, '_first_similar_successor')):
        monkeypatch.setattr(mod, name, counted(calls, name,
                                               getattr(mod, name)))
    from tscode_tpu_torch import embedder
    monkeypatch.setattr(embedder, 'string_embed', functools.partial(
        string.string_embed, device_novelty=True))
    for d in ('string', 'refine', 'search'):
        (tmp_path / d).mkdir()
    config_files('sn2_string', str(tmp_path / 'string'), 4)
    config_files('torsion_drive', str(tmp_path / 'search'), 8)
    (tmp_path / 'search' / 'input.txt').write_text(
        'NOOPT\ncsearch> m1.xyz\n')
    seen = Counter()
    for tag in ('string', 'refine', 'search'):
        inp = tmp_path / tag / 'input.txt'
        if tag == 'refine':
            refine_input(str(tmp_path / 'string' /
                             'tscode_unoptimized_string.xyz'),
                         str(tmp_path / 'refine'))
        calls.clear()
        report = cli(inp, tag, '--device', 'cpu', '--trace',
                     str(tmp_path / f'trace_{tag}'))
        spans = span_counts(tmp_path / f'trace_{tag}')
        for s in (report or {'stages': []})['stages']:
            assert spans[s['stage']] >= 1, (tag, s['stage'], spans)
        for name, n in calls.items():
            assert spans[name] == n, (tag, name, n, spans)
        seen.update(calls)
        if tag == 'refine':
            assert report['final_structures'] > 0
            assert any(k.startswith('rmsd_pass k=') for k in spans)
        if tag == 'search':
            assert spans['rotate_batch_with_backoff'] >= 1
    assert set(seen) == {'prune_conformers_rmsd_device',
                         'tfd_novelty_device', '_first_similar_successor'}


def test_span_is_inert_without_a_trace(tmp_path):
    assert isinstance(backend.span('x'), contextlib.nullcontext)

    @backend.traced
    def kernel_entry(x):
        return x + 1
    assert kernel_entry.__name__ == 'kernel_entry'
    with backend.DeviceTrace(str(tmp_path), 'cpu') as trace:
        assert isinstance(backend.span('x'),
                          torch.profiler.record_function)
        with backend.span('outer'):
            kernel_entry(torch.ones(2))
    assert isinstance(backend.span('x'), contextlib.nullcontext)
    assert trace.path == trace_file(tmp_path)
    spans = span_counts(tmp_path)
    assert spans['outer'] == spans['kernel_entry'] == 1
    assert kernel_entry(torch.ones(2)).tolist() == [2.0, 2.0]


def test_profile_inside_the_trace(tmp_path, capsys):
    sn2_input(tmp_path)
    cwd = os.getcwd()
    try:
        assert main([str(tmp_path / 'input.txt'), '--device', 'cpu', '-p',
                     '--trace', str(tmp_path / 'trace'), '-n', 'p']) == 0
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out
    assert 'Ordered by: cumulative time' in out
    assert f'device trace written to {trace_file(tmp_path / "trace")}' in out


def test_trace_on_a_missing_card_raises_before_profiling(tmp_path,
                                                        monkeypatch):
    sn2_input(tmp_path)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        main([str(tmp_path / 'input.txt'), '--trace',
              str(tmp_path / 'trace')])
    assert not (tmp_path / 'trace').exists()
    assert not backend._TRACING
