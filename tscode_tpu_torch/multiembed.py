'''
Multiembed: combinatorial docking of two polyfunctional molecules
(counterpart of tscode_tpu/multiembed.py).

Every arrangement of interacting atom pairs between the two molecules is
a rigid two-molecule cyclical embed of its own. Each arrangement's child
Embedder is built on the host (parse, orbitals, pivots) and its block
rows are packed; ONE chunked sweep on the run's device then screens the
union of every arrangement's rows (the arrangements share both conformer
ensembles, so the coordinates upload once, and a block's screen and
dedup depend on its own row alone). Each child receives its slice of the
survivors and runs the stages that follow an embed (fitness, TFD and
MOI; its compenetration stage screens nothing, the sweep has screened
every pose), on the run's device. The parent's own compenetration stage
then screens the union of the arrangements' structures with kernel K2.
'''

import os
import sys
import time
from itertools import permutations
from shutil import copy, rmtree

import numpy as np

from tscode_tpu_torch.backend import synchronize
from tscode_tpu_torch.embeds.cyclical import (assemble_survivors,
                                              bimol_rigid_blocks,
                                              concat_blocks, screen_survivors)
from tscode_tpu_torch.errors import InputError, ZeroCandidatesError
from tscode_tpu_torch.ops.linalg import cartesian_product
from tscode_tpu_torch.utils import suppress_stdout_stderr, time_to_string


def multiembed_dispatcher(embedder):
    if len(embedder.objects) == 2:
        return multiembed_bifunctional(embedder)
    raise InputError('The multiembed requested is currently unavailable.')


def _build_child(parent, arrangement, i):
    '''Host phase of one arrangement: write the child input, construct
    the child Embedder and RunEmbedding on the parent's device and
    dtype, and pack the embed's block rows. Returns (run, foldername,
    block dict or None).'''
    from tscode_tpu_torch.embedder import Embedder, RunEmbedding

    (x1, x2), (y1, y2) = arrangement
    start_dir = os.getcwd()
    foldername = f'tscode_embed{i + 1}'
    os.makedirs(foldername, exist_ok=True)

    mol1, mol2 = parent.objects
    copy(os.path.join(start_dir, mol1.name), foldername)
    copy(os.path.join(start_dir, mol2.name), foldername)

    child_input = os.path.join(start_dir, foldername,
                               f'embed{i + 1}_input.txt')
    extra = ''
    extra += ' debug' if parent.options.debug else ''
    extra += ' simpleorbitals' if parent.options.simpleorbitals else ''
    extra += (f' shrink={parent.options.shrink_multiplier}'
              if parent.options.shrink else '')
    with open(child_input, 'w') as f:
        f.write(f'noopt rigid{extra}\n')
        f.write(f'{mol1.name} {x1}x {y1}y\n')
        f.write(f'{mol2.name} {x2}x {y2}y\n')

    try:
        with suppress_stdout_stderr():
            child = Embedder(child_input, stamp=f'embed{i + 1}',
                             device=parent.device, dtype=parent.dtype)
            run = RunEmbedding(child)
            # every child is a NOOPT RIGID two-molecule cyclical embed:
            # pack its block rows now (max_norm_delta=5, as the
            # cyclical_embed dispatcher calls it)
            blk = bimol_rigid_blocks(run.objects[0], run.objects[1],
                                     max_norm_delta=5,
                                     pairing_ok=run.pairing_ok_fn())
            # a child lives until its _finish_child runs: close the log
            # now (reopened there), so a run of many arrangements does
            # not hold hundreds of descriptors open
            run.logfile.close()
    finally:
        os.chdir(start_dir)
    return run, foldername, blk


def _screen_arrangements(parent, children, split=None):
    '''One chunked device sweep over the union of every arrangement's
    block rows. Returns {id(run): (poses (S, N, 3), cons (S, 2, 2))};
    split, when given, gets the sweep's seconds and counts.'''
    trace = os.environ.get('TSCODE_EMBED_TRACE') == '1'

    def clock():
        if trace:
            synchronize(parent.device)
        return time.perf_counter()

    live = [(run, blk) for run, _, blk in children if blk is not None]
    out = {}
    if not live:
        return out

    def sweep(run, blk, split):
        return screen_survivors(
            blk, run.objects,
            np.asarray(run.systematic_angles, dtype=float),
            run.options.clash_thresh, device=parent.device,
            dtype=parent.dtype, clock=clock, split=split)

    # children whose angle grid equals the first one's are swept
    # together; any other (not produced by this dispatcher) on its own
    angles0 = np.asarray(live[0][0].systematic_angles, dtype=float)
    batched = [(run, blk) for run, blk in live
               if np.array_equal(
                   np.asarray(run.systematic_angles, dtype=float), angles0)]
    solo = [(run, blk) for run, blk in live
            if not any(run is r for r, _ in batched)]

    t0 = clock()
    sweep_split = {}
    surv_all, keep_all = sweep(batched[0][0],
                               concat_blocks([blk for _, blk in batched]),
                               sweep_split)
    t1 = clock()
    # survivors arrive in generation order, so each arrangement's are
    # contiguous: slice them by the keep counts
    lo = s_lo = 0
    for run, blk in batched:
        n = len(blk['ids'])
        keep = keep_all[lo:lo + n]
        n_surv = int(keep.sum())
        out[id(run)] = assemble_survivors(surv_all[s_lo:s_lo + n_surv], keep,
                                          blk['ids'])
        lo += n
        s_lo += n_surv
    t2 = time.perf_counter()

    for run, blk in solo:
        surv, keep = sweep(run, blk, None)
        out[id(run)] = assemble_survivors(surv, keep, blk['ids'])

    if split is not None:
        split.update(sweep_split, sweep_s=t1 - t0, assemble_s=t2 - t1,
                     union_blocks=int(len(keep_all)), solo=len(solo),
                     union_candidates=int(keep_all.size),
                     union_survivors=int(keep_all.sum()))
    return out


def multiembed_bifunctional(embedder):
    '''Explore every relative arrangement of reactive-index pairs
    between the two molecules. Sets embedder.constrained_indices and
    returns the structures of every arrangement, in arrangement order
    (itertools.permutations of the index pairs).'''
    mol1, mol2 = embedder.objects
    trace = os.environ.get('TSCODE_EMBED_TRACE') == '1'

    pairs = cartesian_product(mol1.reactive_indices, mol2.reactive_indices)
    arrangements = [((x1, x2), (y1, y2))
                    for ((x1, x2), (y1, y2)) in permutations(map(tuple, pairs), 2)
                    if x1 != y1 and x2 != y2]

    embedder.t_start_run = time.perf_counter()
    embedder.log(f'--> Multiembed: running {len(arrangements)} embeds '
                 f'(one sweep on {embedder.device}, in-process)')

    # host phase: every child built and its block rows packed; when a
    # build fails, drop the folders built so far
    t0 = time.perf_counter()
    children = []
    try:
        for i, arrangement in enumerate(arrangements):
            children.append(_build_child(embedder, arrangement, i))
    except BaseException:
        if not embedder.options.debug:
            for _, foldername, _ in children:
                rmtree(os.path.join(os.getcwd(), foldername),
                       ignore_errors=True)
        raise
    blocks_s = time.perf_counter() - t0

    # device phase: one sweep over the union of rows
    t0 = time.perf_counter()
    split = {}
    screened = _screen_arrangements(embedder, children, split)
    embedder.log(f'--> Multiembed: screened all arrangements in '
                 f'{time_to_string(time.perf_counter() - t0, verbose=True)}.')

    structures_out, constr_ids, records = [], [], []
    start_dir = os.getcwd()
    for i, (run, foldername, blk) in enumerate(children):
        t0 = time.perf_counter()
        pre = screened.get(id(run), (np.array([]), np.array([])))
        structures, constrained = _finish_child(embedder, run, foldername,
                                                pre)
        seconds = time.perf_counter() - t0
        embedder.log(f'--> Arrangement {i + 1:3}/{len(arrangements):3}: '
                     f'generated {len(structures):4} candidates in '
                     f'{time_to_string(seconds, verbose=True)}.')
        n_angles = len(run.systematic_angles)
        records.append({
            'arrangement': [[int(a) for a in p] for p in arrangements[i]],
            'blocks': 0 if blk is None else int(len(blk['ids'])),
            'candidates': 0 if blk is None else int(len(blk['ids'])
                                                     * n_angles),
            'survivors': int(len(pre[0])),
            'stages': [[s['stage'], s['structures_in'], s['structures_out']]
                       for s in getattr(run, 'stage_timings', [])],
            'structures': int(len(structures)),
            'seconds': round(seconds, 4)})
        if len(structures) > 0:
            structures_out.append(structures)
            constr_ids.append(constrained)
    os.chdir(start_dir)

    embedder.embed_info.update(
        arrangements=len(arrangements), blocks_s=blocks_s,
        children=records, trace=trace,
        dtype=str(embedder.dtype).split('.')[-1],
        device=str(embedder.device), **split)
    if trace:
        print(f'[multiembed trace] {len(arrangements)} arrangements: blocks '
              f'{blocks_s:.3f}s, screen {split.get("screen_s", 0):.3f}s, '
              f'dedup {split.get("dedup_s", 0):.3f}s '
              f'({split.get("sweep_kernel")}), assemble '
              f'{split.get("assemble_s", 0):.3f}s '
              f'({split.get("union_blocks", 0)} blocks in '
              f'{split.get("chunks", 0)} chunks, '
              f'{split.get("union_survivors", 0)} survivors); children '
              + ', '.join(f'{r["seconds"]:.3f}s' for r in records),
              file=sys.stderr, flush=True)

    if not structures_out:
        raise ZeroCandidatesError(
            '--> Multiembed did not find any suitable disposition of '
            'molecules in any arrangement.')

    structures_out = np.concatenate(structures_out)
    embedder.constrained_indices = np.concatenate(constr_ids)

    embedder.log(f'\n--> Multiembed completed: generated '
                 f'{len(structures_out)} candidates in '
                 f'{time_to_string(time.perf_counter() - embedder.t_start_run, verbose=True)}.')
    return structures_out


def _finish_child(parent, run, foldername, precomputed):
    '''Refining phase of one arrangement: hand the child its slice of
    the shared sweep and run the stages that follow an embed, on the
    run's device. The child's folder is removed unless DEBUG holds.'''
    start_dir = os.getcwd()
    os.chdir(os.path.join(start_dir, foldername))
    try:
        with suppress_stdout_stderr():
            # _build_child closed the log to bound open descriptors
            run.logfile = open(f'tscode_{run.stamp}.log', 'a',
                               buffering=1, encoding='utf-8')
            run.precomputed_embed = precomputed
            try:
                run.generate_candidates()
                run.compenetration_refining()
                run.fitness_refining()
                run.similarity_refining(rmsd=False)
                if parent.options.debug and len(run.structures):
                    # keep the structures the debug folder exists for
                    run.write_structures('unoptimized', energies=False)
            except ZeroCandidatesError:
                run.structures = np.array([])
                run.constrained_indices = np.array([])
        structures = run.structures
        constrained = run.constrained_indices
        run.logfile.close()
    finally:
        os.chdir(start_dir)
        if not parent.options.debug:
            rmtree(os.path.join(start_dir, foldername), ignore_errors=True)

    return structures, constrained
