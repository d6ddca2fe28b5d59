'''
OpenBabel force-field adapter (UFF / MMFF94 / Ghemical / GAFF).

Parity target: reference calculators/_openbabel.py:27-148
(openbabel_opt). The reference disconnected this module from its
embedder in v0.4.4 but keeps it as a faster, less robust alternative to
the xtb FF; it is provided here with the same contract and wired behind
`OBABEL_AVAILABLE` so a user migrating from the reference finds it.

Two execution paths:
 * the `openbabel` python bindings when importable — full parity
   (atom-freeze or distance constraints via OBFFConstraints, FF energy
   in kcal/mol);
 * the `obabel` CLI otherwise — unconstrained minimization only (the
   CLI has no constraint interface); constrained calls raise a clear
   error instead of silently dropping the constraint.
'''

import os
import subprocess
import tempfile

import numpy as np

from tscode_tpu_torch.errors import InputError
from tscode_tpu_torch.io_xyz import read_xyz, write_xyz

_KJ_TO_KCAL = 0.2390057361376673

_OB_METHODS = ('UFF', 'MMFF94', 'Ghemical', 'GAFF')


def _have_ob_bindings():
    try:
        from openbabel import openbabel  # noqa: F401
        return True
    except ImportError:
        return False


def probe_openbabel(method='UFF'):
    '''Fail-fast availability check for the FFCALC=OB refine stage:
    raises InputError with an actionable message when neither the
    python bindings nor the obabel CLI are present, or when the
    requested force field is not one OpenBabel implements. Without
    this, a systemic failure surfaced only as every job being masked
    out and a confusing downstream ZeroCandidatesError.'''
    import shutil
    if method not in _OB_METHODS:
        raise InputError(
            f'OpenBabel implements only the {", ".join(_OB_METHODS)} '
            f'force fields (got {method!r}); set FFLEVEL accordingly.')
    if not _have_ob_bindings() and shutil.which('obabel') is None:
        raise InputError(
            'FFCALC=OB needs OpenBabel, but neither the python bindings '
            '(openbabel module) nor the obabel CLI are available. '
            'Install one of them, or use FFCALC=XTB.')


def _place_at_distance(structure, a, b, target_d):
    '''Move atom b along the a->b axis so |b - a| == target_d.'''
    delta_vec = structure[b] - structure[a]
    d = float(np.linalg.norm(delta_vec))
    structure[b] -= delta_vec / d * (d - target_d)


def _stepwise_distance_walk(structure, constrained_indices,
                            constrained_distances, optimize_step):
    '''Walk each constrained pair toward its target in 0.2 A steps,
    RE-OPTIMIZING (frozen constrained atoms) after every step — the
    iterative form of the reference's recursion (_openbabel.py:59-84),
    which exists precisely so the force field never perceives a
    teleported, possibly-clashing geometry and scrambles. optimize_step:
    structure -> structure (one constrained OB minimization).'''
    structure = np.asarray(structure, dtype=float).copy()
    while True:
        worst = 0.0
        for target_d, (a, b) in zip(constrained_distances,
                                    constrained_indices):
            if target_d is None:
                continue
            d = float(np.linalg.norm(structure[b] - structure[a]))
            worst = max(worst, abs(d - target_d))
        if worst <= 0.2:
            break
        for target_d, (a, b) in zip(constrained_distances,
                                    constrained_indices):
            if target_d is None:
                continue
            d = float(np.linalg.norm(structure[b] - structure[a]))
            delta = d - target_d
            if abs(delta) > 0.2:
                _place_at_distance(structure, a, b,
                                   d - 0.2 * np.sign(delta))
        structure = optimize_step(structure)
    for target_d, (a, b) in zip(constrained_distances,
                                constrained_indices):
        if target_d is not None:
            _place_at_distance(structure, a, b, target_d)
    return structure


def _opt_with_bindings(structure, atomnos, constrained_indices, method,
                       nsteps, tight_constraint, constrained_distances,
                       title):
    from openbabel import openbabel as ob

    with tempfile.TemporaryDirectory(prefix='tscode_ob_') as cwd:
        inname = os.path.join(cwd, f'{title}_in.xyz')
        outname = os.path.join(cwd, f'{title}_out.xyz')
        with open(inname, 'w') as f:
            write_xyz(structure, atomnos, f)

        conv = ob.OBConversion()
        conv.SetInAndOutFormats('xyz', 'xyz')
        mol = ob.OBMol()
        conv.ReadFile(mol, inname)

        constraints = ob.OBFFConstraints()
        for i, (a, b) in enumerate(constrained_indices):
            if tight_constraint:
                # freezing both atoms is more accurate than the native
                # distance constraint (reference _openbabel.py:105-108)
                constraints.AddAtomConstraint(int(a + 1))
                constraints.AddAtomConstraint(int(b + 1))
            else:
                if constrained_distances is None:
                    length = mol.GetAtom(int(a + 1)).GetDistance(int(b + 1))
                else:
                    length = constrained_distances[i]
                constraints.AddDistanceConstraint(int(a + 1), int(b + 1),
                                                  float(length))

        forcefield = ob.OBForceField.FindForceField(method)
        forcefield.Setup(mol, constraints)
        forcefield.SetConstraints(constraints)
        forcefield.ConjugateGradients(nsteps)
        forcefield.GetCoordinates(mol)
        energy = forcefield.Energy() * _KJ_TO_KCAL

        conv.WriteFile(mol, outname)
        conv.CloseOutFile()
        opt_coords = read_xyz(outname).atomcoords[0]
    return opt_coords, energy


def _opt_with_cli(structure, atomnos, method, nsteps, title):
    '''`obabel --minimize` path: no constraint support in the CLI.'''
    with tempfile.TemporaryDirectory(prefix='tscode_ob_') as cwd:
        inname = os.path.join(cwd, f'{title}_in.xyz')
        outname = os.path.join(cwd, f'{title}_out.xyz')
        with open(inname, 'w') as f:
            write_xyz(structure, atomnos, f)
        with open(os.path.join(cwd, 'out.log'), 'w') as log:
            subprocess.check_call(
                ['obabel', inname, '-O', outname, '--minimize',
                 '--ff', method, '--steps', str(nsteps), '--sd'],
                stdout=log, stderr=subprocess.STDOUT, cwd=cwd)
        opt_coords = read_xyz(outname).atomcoords[0]
    return opt_coords, None


def openbabel_opt(structure, atomnos, constrained_indices=None,
                  constrained_distances=None, tight_constraint=True,
                  graphs=None, check=False, method='UFF', nsteps=1000,
                  title='temp_ob', **kwargs):
    '''
    MM optimization through OpenBabel (reference _openbabel.py:27-148).
    Returns (opt_coords, energy kcal/mol | None, success).

    tight_constraint: True freezes the constrained atoms in place after
    a step-wise distance walk (the reference's accurate mode); False
    uses OpenBabel's native distance constraint.
    check: run the scramble check against `graphs` and report success.
    '''
    assert not check or graphs is not None, \
        'Either provide molecular graphs or do not check for scrambling.'
    if method not in _OB_METHODS:
        raise InputError(
            f'OpenBabel implements only the {", ".join(_OB_METHODS)} '
            f'force fields (got {method!r}).')

    structure = np.asarray(structure, dtype=float).copy()
    constrained_indices = ([] if constrained_indices is None
                           else list(constrained_indices))

    have_bindings = _have_ob_bindings()
    if len(constrained_indices) and not have_bindings:
        raise InputError(
            'Constrained OpenBabel optimization needs the openbabel '
            'python bindings (the obabel CLI has no constraint '
            'interface); install them or use the xtb/internal FF path.')

    if constrained_distances is not None and tight_constraint:
        def optimize_step(s):
            return _opt_with_bindings(s, atomnos, constrained_indices,
                                      method, nsteps, tight_constraint,
                                      constrained_distances, title)[0]
        structure = _stepwise_distance_walk(structure,
                                            constrained_indices,
                                            constrained_distances,
                                            optimize_step)

    if have_bindings:
        opt_coords, energy = _opt_with_bindings(
            structure, atomnos, constrained_indices, method, nsteps,
            tight_constraint, constrained_distances, title)
    else:
        opt_coords, energy = _opt_with_cli(structure, atomnos, method,
                                           nsteps, title)

    if check:
        from tscode_tpu_torch.utils import scramble_check
        excluded = (np.asarray(constrained_indices).ravel()
                    if len(constrained_indices) else np.array((), int))
        success = scramble_check(opt_coords, atomnos, excluded, graphs)
    else:
        success = True

    return opt_coords, energy, success
