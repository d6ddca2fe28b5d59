'''
Operator dispatcher: the `op>` prefixes of a molecule line, run before
the embed (counterpart of tscode_tpu/operators.py). Each operator takes
and returns a Molecule.

Ported: refine> (the refine route, set up by the options), and the
conformer searches csearch>, csearch_hb> and rsearch>. The others need
the refinement and calculator layers (ROADMAP.md item 15) and raise;
an unknown name raises InputError. Also here: the gradient source of
the bending procedures.
'''

from tscode_tpu_torch.errors import InputError
from tscode_tpu_torch.settings import XTB_AVAILABLE

# the JAX package's operators that need item 15
NOT_PORTED = ('opt', 'mtd_search', 'mtd', 'neb', 'saddle', 'scan', 'automep',
              'mep_relax', 'pka')


def operate(op, embedder, mol):
    '''Dispatch a single operator string (without the trailing >).'''
    name = op.split('>')[0].strip()
    handlers = {
        'refine': _refine_operator,
        'csearch': _csearch_operator,
        'csearch_hb': _csearch_hb_operator,
        'rsearch': _rsearch_operator,
    }
    handler = handlers.get(name)
    if handler is None:
        if name in NOT_PORTED:
            from tscode_tpu_torch.embedder import not_ported
            raise not_ported(f'The {name}> operator', 15)
        raise InputError(f'Operator {name!r}> not recognized.')
    return handler(embedder, mol)


def _refine_operator(embedder, mol):
    # handled by OptionSetter._refine_operator_routine via options.operators
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
    and theory level. Returns None when no gradient-capable calculator
    is available, in which case the procedures use the internal force
    field. With XTB chosen and installed the callback would come from
    the calculators, which are not ported: that raises.'''
    if embedder.options.calculator != 'XTB' or not XTB_AVAILABLE:
        return None
    from tscode_tpu_torch.embedder import not_ported
    raise not_ported('Bending on XTB gradients (the calculators)', 15)
