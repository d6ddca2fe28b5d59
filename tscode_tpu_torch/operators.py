'''
Operator dispatcher: the `op>` prefixes of a molecule line, run before
the embed (counterpart of tscode_tpu/operators.py). Each operator takes
and returns a Molecule.

refine> (the refine route, set up by the options), opt> (the ensemble
optimised on the calculator, then pruned), the conformer searches
csearch>, csearch_hb> and rsearch>, mtd> and mtd_search> (CREST), and
the operators whose run ends with their data: scan> (distance and
dihedral scans), neb> and mep_relax> (climbing-image NEB), saddle> (the
dimer method), automep> (a ring-flip path) and pka>. An unknown name
raises InputError. Also here: the gradient source of the bending, NEB
and saddle procedures.
'''

import numpy as np

from tscode_tpu_torch.errors import InputError
from tscode_tpu_torch.settings import DEFAULT_LEVELS, XTB_AVAILABLE


def operate(op, embedder, mol):
    '''Dispatch a single operator string (without the trailing >).'''
    name = op.split('>')[0].strip()
    handlers = {
        'refine': _refine_operator,
        'opt': _opt_operator,
        'csearch': _csearch_operator,
        'csearch_hb': _csearch_hb_operator,
        'rsearch': _rsearch_operator,
        'mtd_search': _mtd_operator,
        'mtd': _mtd_operator,
        'neb': _neb_operator,
        'saddle': _saddle_operator,
        'scan': _scan_operator,
        'automep': _automep_operator,
        'mep_relax': _mep_relax_operator,
        'pka': _pka_operator,
    }
    handler = handlers.get(name)
    if handler is None:
        raise InputError(f'Operator {name!r}> not recognized.')
    return handler(embedder, mol)


def _refine_operator(embedder, mol):
    # handled by OptionSetter._refine_operator_routine via options.operators
    return mol


def _scan_operator(embedder, mol):
    # the scan runs here, during operator application; _setup then routes
    # the run to the 'data' termination
    from tscode_tpu_torch.scans import scan_operator
    return scan_operator(embedder, mol)


def _require_calc(embedder, what):
    if embedder.options.calculator is None:
        raise InputError(
            f'{what} requires an external calculator (xtb/orca/gaussian/'
            f'mopac), none of which was found on PATH.')


def _opt_operator(embedder, mol):
    _require_calc(embedder, 'opt>')
    from tscode_tpu_torch.optimization import optimize_ensemble
    return optimize_ensemble(embedder, mol)


def _mtd_operator(embedder, mol):
    _require_calc(embedder, 'mtd_search>')
    from tscode_tpu_torch.calculators.xtb import crest_mtd_search_operator
    return crest_mtd_search_operator(embedder, mol)


def _automep_operator(embedder, mol):
    from tscode_tpu_torch.automep import automep
    n_images = getattr(embedder.options, 'images', None) or 9
    automep(embedder, n_images=n_images)
    return mol


def _pka_operator(embedder, mol):
    from tscode_tpu_torch.pka import pka_routine
    pka_routine(mol.name, embedder)
    return mol


def _csearch_operator(embedder, mol):
    from tscode_tpu_torch.torsions import csearch_operator
    return csearch_operator(embedder, mol, mode=1)


def _csearch_hb_operator(embedder, mol):
    from tscode_tpu_torch.torsions import csearch_operator
    return csearch_operator(embedder, mol, mode=1, keep_hb=True)


def _rsearch_operator(embedder, mol):
    from tscode_tpu_torch.torsions import csearch_operator
    return csearch_operator(embedder, mol, mode=2)


def qm_gradient_source(embedder, mol, chain=False):
    '''(energy, gradient) callback resolved from the run's calculator
    and theory level, the analog of the reference's get_ase_calc
    (ase_manipulations.py:123-214); chain=True gives the per-image form
    for NEB bands. None when the calculator is not XTB or xtb was not
    on PATH when settings were read: the procedures (bending, NEB,
    saddle refinement) then run on the internal force field.'''
    if embedder.options.calculator != 'XTB' or not XTB_AVAILABLE:
        return None
    from tscode_tpu_torch.calculators.gradients import (
        make_chain_gradient_fn, make_gradient_fn)
    make = make_chain_gradient_fn if chain else make_gradient_fn
    return make(
        mol.atomnos,
        calculator='XTB',
        method=embedder.options.theory_level or DEFAULT_LEVELS['XTB'],
        solvent=embedder.options.solvent,
        charge=embedder.options.charge,
        procs=getattr(embedder, 'procs', None) or 1,
        maxthreads=getattr(embedder, 'threads', None) or 4)


def _neb_operator(embedder, mol):
    '''neb>: climbing-image NEB from 2 (ends), 3 (ends + TS guess) or an
    odd-N chain of input structures, on the internal force field.'''
    from tscode_tpu_torch.ff import ff_energy, molecule_params
    from tscode_tpu_torch.io_xyz import write_xyz
    from tscode_tpu_torch.molecule import align_structures
    from tscode_tpu_torch.neb import idpp_interpolate, run_neb

    n = mol.n_confs
    if n < 2:
        raise InputError('neb> needs at least two structures '
                         '(reagent and product).')

    images = getattr(embedder.options, 'images', None) or \
        (embedder.options.neb.images if embedder.options.neb else 7)
    device = embedder.device

    # center + Kabsch-align every image to the first so interpolation
    # does not sweep through rigid-rotation garbage
    aligned = align_structures(mol.atomcoords)
    start, end = aligned[0], aligned[-1]
    if n == 2:
        chain = None
    elif n == 3:
        # ends + TS guess: two IDPP half-bands through the guess, so the
        # band has `images` movable resolution instead of one interior
        # image
        images = max(int(images), 5)
        half = images // 2 + 1
        chain = np.concatenate([
            idpp_interpolate(aligned[0], aligned[1], half, device=device),
            idpp_interpolate(aligned[1], aligned[2], images - half + 1,
                             device=device)[1:]])
    else:
        # a user-provided chain becomes the starting band
        chain = aligned
        images = n

    qm_grad = qm_gradient_source(embedder, mol, chain=True)
    if qm_grad is not None:
        from tscode_tpu_torch.neb import run_neb_callback
        embedder.log(f'--> {mol.rootname}: CI-NEB with {images} images '
                     f'({embedder.options.calculator} '
                     f'{embedder.options.theory_level} forces)')

        # fault tolerance: the band is checkpointed to disk, and a
        # crashed gradient subprocess or an unconverged (max-iter) band
        # restarts from the last checkpoint for up to `attempts` tries
        attempts = 5
        chkpt_path = f'{mol.rootname}_MEP_chkpt.xyz'
        last = {'chain': chain}

        def _checkpoint(band):
            last['chain'] = np.asarray(band)
            with open(chkpt_path, 'w') as f:
                for i, s in enumerate(last['chain']):
                    write_xyz(s, mol.atomnos, f,
                              title=f'NEB checkpoint image '
                                    f'{i + 1}/{len(last["chain"])}')

        for attempt in range(attempts):
            try:
                chain, energies, ts, converged = run_neb_callback(
                    start, end, qm_grad, n_images=images,
                    chain=last['chain'], checkpoint_fn=_checkpoint,
                    with_status=True, device=device)
            except Exception as e:
                if attempt + 1 >= attempts:
                    raise
                embedder.log(f'    NEB gradient evaluation failed '
                             f'({type(e).__name__}: {e}) - restarting '
                             f'from checkpoint. Attempt '
                             f'{attempt + 2}/{attempts}.')
                continue
            if converged or attempt + 1 >= attempts:
                break
            embedder.log(f'--> Band not converged: restarting NEB from '
                         f'checkpoint. Attempt {attempt + 2}/{attempts}.')
            last['chain'] = chain
    else:
        embedder.log(f'--> {mol.rootname}: CI-NEB with {images} images '
                     f'(internal FF surface)')
        chain, energies, ts = run_neb(
            start, end, ff_energy, n_images=images, chain=chain,
            energy_args=(molecule_params(mol, device),), device=device)

    with open(f'{mol.rootname}_MEP.xyz', 'w') as f:
        for i, (s, e) in enumerate(zip(chain, energies)):
            write_xyz(s, mol.atomnos, f,
                      title=f'MEP image {i + 1}/{len(chain)} - Rel. E = '
                            f'{round(e - energies[0], 2)} kcal/mol')
    with open(f'{mol.rootname}_NEB_TS.xyz', 'w') as f:
        write_xyz(chain[ts], mol.atomnos, f,
                  title=f'NEB TS guess - Rel. E = '
                        f'{float(energies[ts] - energies[0]):.2f} kcal/mol')
    wrote = _write_neb_plot(embedder, mol.rootname, energies, ts)
    embedder.log(f'    TS guess at image {ts + 1}, barrier '
                 f'{float(energies[ts] - energies[0]):.2f} kcal/mol; wrote '
                 f'{mol.rootname}_MEP.xyz, {mol.rootname}_NEB_TS.xyz'
                 + (f' and {wrote}' if wrote else ''))
    return mol


def _write_neb_plot(embedder, rootname, energies, ts):
    '''Relative-energy band plot with the TS image marked; returns its
    file name, or None (logged) where matplotlib is not installed.'''
    from tscode_tpu_torch.utils import pyplot
    name = f'{rootname}_NEB_plt.svg'
    plt = pyplot()
    if plt is None:
        embedder.log(f'--> matplotlib is not installed: skipped the plot '
                     f'{name}')
        return None
    energies = np.asarray(energies, dtype=float)
    rel = energies - energies.min()
    plt.figure()
    plt.plot(range(1, len(rel) + 1), rel, color='tab:blue',
             label='Image energies', linewidth=3)
    plt.plot([ts + 1], [rel[ts]], color='gold', label='TS guess',
             marker='o', markersize=3)
    plt.legend()
    plt.title(rootname)
    plt.xlabel('Image number')
    plt.ylabel('Rel. E. (kcal/mol)')
    plt.savefig(name)
    plt.close()
    return name


def _mep_relax_operator(embedder, mol):
    '''mep_relax>: relax a user-provided image chain. The internal force
    field is graph-restrained by construction, so the one pass of
    neb> is already the bond-locked ("safe") pass.'''
    return _neb_operator(embedder, mol)


def _saddle_operator(embedder, mol):
    '''saddle>: first-order saddle refinement of a single structure
    (dimer method on the internal force field).'''
    from tscode_tpu_torch.io_xyz import write_xyz
    from tscode_tpu_torch.saddle import saddle_refine_structure

    qm_grad = qm_gradient_source(embedder, mol)
    if qm_grad is not None:
        from tscode_tpu_torch.saddle import dimer_saddle_callback
        embedder.log(f'--> {mol.rootname}: dimer saddle refinement '
                     f'({embedder.options.calculator} '
                     f'{embedder.options.theory_level} forces)')
        coords, energy, done = dimer_saddle_callback(
            mol.atomcoords[0], qm_grad)
    else:
        embedder.log(f'--> {mol.rootname}: dimer saddle refinement '
                     f'(internal FF surface)')
        coords, energy, done = saddle_refine_structure(
            mol.atomcoords[0], mol.atomnos, mol.graph,
            device=embedder.device)
    with open(f'{mol.rootname}_saddle.xyz', 'w') as f:
        write_xyz(coords, mol.atomnos, f,
                  title=f'Saddle structure - E = {float(energy):.2f} '
                        f'kcal/mol - converged: {done}')
    embedder.log(f'    wrote {mol.rootname}_saddle.xyz '
                 f'(converged: {done})')
    return mol
