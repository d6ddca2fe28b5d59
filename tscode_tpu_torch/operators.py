'''
Gradient source of the bending procedures (counterpart of
tscode_tpu/operators.py's qm_gradient_source; the operators themselves
are not ported, ROADMAP.md item 15).
'''

from tscode_tpu_torch.settings import XTB_AVAILABLE


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
