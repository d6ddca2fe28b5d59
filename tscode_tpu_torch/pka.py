'''
pKa workflow: free-energy difference between an acid/base and its
conjugate, relative to a reference compound (counterpart of
tscode_tpu/pka.py; reference TSCoDe's pka.py). The conformer search
runs on the run's device and draws from the embedder's rng.

Structure manipulation (deprotonation, protonation geometry) is pure and
always available; the free-energy legs require XTB.
'''

import numpy as np

from tscode_tpu_torch.errors import InputError
from tscode_tpu_torch.graphs import graphize, neighbors


def deprotonate(coords, atomnos, index):
    '''Remove the proton at `index`; returns (coords, atomnos).'''
    if atomnos[index] != 1:
        raise InputError(
            f'pKa deprotonation index {index} is not a hydrogen atom '
            f'(Z={atomnos[index]}).')
    return np.delete(coords, index, axis=0), np.delete(atomnos, index)


def protonate(coords, atomnos, index, length=1.0):
    '''Add a proton at `index`, opposite the mean neighbor direction
    (reference pka.py:134-147). Returns new coords (atomnos gains H).'''
    graph = graphize(coords, atomnos)
    nbs = neighbors(graph, int(index))
    mean = np.mean(coords[nbs] - coords[index], axis=0)
    versor = -mean / np.linalg.norm(mean)
    new_proton = coords[index] + length * versor
    return np.append(coords, [new_proton], axis=0)


def pka_routine(filename, embedder, search=True):
    '''Full pKa protocol: conformer search, optimization, XTB hessian
    free energies for HA/A- or B/BH+, ladder vs the PKA= reference
    (reference pka.py:149-247).'''
    if embedder.options.calculator != 'XTB':
        raise InputError(
            'pKa calculations require the XTB calculator '
            '(charge-changing free energies).')

    mol = next(m for m in embedder.objects if m.name == filename)
    if len(mol.reactive_indices) != 1:
        raise InputError(
            'Please only specify one reactive atom for pKa calculations')

    index = int(mol.reactive_indices[0])
    embedder.log(f'--> pKa computation protocol for {mol.name}, '
                 f'index {index}')

    structures = mol.atomcoords
    if search:
        from tscode_tpu_torch.torsions import csearch
        structures = csearch(mol.atomcoords[0], mol.atomnos,
                             n_out=10, mode=1, title=mol.rootname,
                             logfunction=embedder.log, rng=embedder.rng,
                             device=embedder.device)

    from tscode_tpu_torch.calculators.dispatch import optimize
    from tscode_tpu_torch.calculators.xtb import xtb_get_free_energy

    def _best_free_energy(ensemble, atomnos, charge):
        best = None
        for s, coords in enumerate(ensemble):
            opt_coords, energy, ok = optimize(
                coords, atomnos, 'XTB',
                solvent=embedder.options.solvent, charge=charge,
                procs=embedder.procs, title=f'pka_{charge}_{s}')
            if not ok:
                continue
            g = xtb_get_free_energy(opt_coords, atomnos,
                                    solvent=embedder.options.solvent,
                                    charge=charge, procs=embedder.procs,
                                    title=f'pka_G_{charge}_{s}')
            if g is not None and (best is None or g < best):
                best = g
        return best

    is_acidic_h = mol.atomnos[index] == 1

    g_neutral = _best_free_energy(structures, mol.atomnos, 0)

    if is_acidic_h:
        conj = [np.delete(s, index, axis=0) for s in structures]
        conj_nos = np.delete(mol.atomnos, index)
        g_conj = _best_free_energy(conj, conj_nos, -1)
        label = 'HA -> A-'
    else:
        conj = [protonate(s, mol.atomnos, index) for s in structures]
        conj_nos = np.append(mol.atomnos, 1)
        g_conj = _best_free_energy(conj, conj_nos, +1)
        label = 'B -> BH+'

    if g_neutral is None or g_conj is None:
        raise InputError('pKa free-energy legs failed to converge.')

    # both legs store G(product) - G(reactant), exactly as the reference
    # does (pka.py:221, :245) — pka_termination's ladder and equilibrium
    # formulas depend on this sign convention
    dg = g_conj - g_neutral
    embedder.log(f'    {label}: dG = {round(dg, 2)} kcal/mol')

    mol.pka_data = (label, dg)
    if hasattr(embedder, 'pka_ref'):
        ref_name, ref_pka = embedder.pka_ref
        embedder.log(f'    reference: {ref_name} (pKa {ref_pka})')
    return dg
