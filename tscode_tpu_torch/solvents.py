'''
Solvent database: xtb implicit-solvent names, dielectric constants, common
synonyms and the per-calculator solvation input line
(reference TSCoDe's solvents.py:21-121).
'''

XTB_SOLVENTS = (
    'acetone', 'acetonitrile', 'aniline', 'benzaldehyde', 'benzene',
    'ch2cl2', 'chcl3', 'cs2', 'dioxane', 'dmf', 'dmso', 'ether',
    'ethylacetate', 'furane', 'hexadecane', 'hexane', 'methanol',
    'nitromethane', 'octanol', 'octanolwet', 'phenol', 'toluene', 'thf',
    'water', 'none',
)

# static dielectric constants at ~25 C
EPSILON_DICT = {
    'aceticacid': 6.15,
    'acetone': 20.7,
    'acetonitrile': 37.5,
    'aniline': 7.06,
    'benzaldehyde': 17.9,
    'benzene': 2.28,
    'chloroform': 4.8,
    'cs2': 2.63,
    'ch2cl2': 8.93,
    'dioxane': 2.25,
    'dmf': 36.71,
    'dmso': 46.68,
    'et2o': 4.27,
    'dimethylether': 6.18,
    'ethanol': 24.3,
    'methanol': 32.63,
    'ethylacetate': 6.02,
    'furan': 2.94,
    'hexadecane': 2.05,
    'octanol': 10.30,
    'phenol': 12.4,
    'toluene': 2.38,
    'thf': 7.58,
    'water': 80.1,
}

SOLVENT_SYNONYMS = {
    'ch3cooh': 'aceticacid',
    'ch3cn': 'acetonitrile',
    'ch3cl': 'chloroform',
    'dcm': 'ch2cl2',
    'dichloromethane': 'ch2cl2',
    'carbondisuphide': 'cs2',
    'carbondisulfide': 'cs2',
    'diethylether': 'et2o',
    'etoh': 'ethanol',
    'ch3oh': 'methanol',
    'meoh': 'methanol',
    'h2o': 'water',
}

# kept as lowercase aliases for call sites mirroring the reference names
solvent_synonyms = SOLVENT_SYNONYMS
epsilon_dict = EPSILON_DICT


def get_solvent_line(solvent, calculator, theory_level=None):
    '''Solvation input fragment for the given calculator; '' for None.'''
    if solvent is None:
        return ''
    solvent = SOLVENT_SYNONYMS.get(solvent, solvent)
    if solvent not in EPSILON_DICT:
        raise ValueError(
            f'Solvent {solvent!r} not recognized. Implemented solvents: '
            f'{", ".join(sorted(EPSILON_DICT))}. Note that not all solvents '
            f'work with all calculators.')
    builders = {
        'MOPAC': lambda: f'EPS={EPSILON_DICT[solvent]}',
        'GAUSSIAN': lambda: f'scrf=(cpcm,solvent={solvent})',
        'ORCA': lambda: f'! CPCM\n%cpcm\nepsilon {EPSILON_DICT[solvent]}\nend',
    }
    if calculator not in builders:
        return ''
    return builders[calculator]()
