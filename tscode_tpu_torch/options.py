'''
Run options and the keyword system.

Same keyword surface as the reference (embedder_options.py:31-156) with
the same priority ordering and per-keyword semantics; defaults at
embedder_options.py:162-281.
'''

from tscode_tpu_torch.settings import (CALCULATOR, DEFAULT_FF_LEVELS, FF_CALC,
                                 FF_OPT_BOOL)

# keyword -> priority (1 first, higher numbers later)
KEYWORDS = {
    'BYPASS': 1,        # skip pruning/optimization, dump all embedded poses
    'CALC': 1,          # override the calculator
    'CHARGE': 1,        # total charge
    'CHECK': 1,         # inspect input structures (headless: writes files)
    'CONFS': 1,         # max conformers used per molecule
    'CLASHES': 1,       # CLASHES(num=3,dist=1.2)
    'CRESTNCI': 1,      # pass --nci to CREST
    'DEEP': 1,          # deeper search presets
    'DEBUG': 1,         # stage-by-stage dumps
    'DIST': 2,          # DIST(a=2.345,b=3.67) imposed pair distances
    'DRYRUN': 1,        # control flow only, no compute
    'EZPROT': 1,        # double bond protection
    'FFOPT': 1,         # FFOPT=ON/OFF
    'FFCALC': 1,        # override FF calculator
    'FFLEVEL': 1,       # override FF level
    'IMAGES': 1,        # NEB / mep_relax image count
    'KCAL': 1,          # energy window
    'LET': 1,           # lift safety caps
    'LEVEL': 1,         # theory level
    'MTD': 1,           # metadynamics augmentation
    'NCI': 1,           # print noncovalent interactions
    'NEB': 1,           # NEB(images=8,preopt=true)
    'NEWBONDS': 1,      # scramble tolerance
    'NOOPT': 1,         # skip optimization
    'ONLYREFINED': 1,   # drop structures that fail refinement
    'PKA': 1,           # PKA(mol.xyz)=n reference pKa
    'PROCS': 1,         # cores per QM job
    'REFINE': 1,        # same as refine> on the (single) input ensemble
    'RIGID': 1,         # no bending in cyclical embeds
    'ROTRANGE': 1,      # cyclical rotation range
    'SADDLE': 1,        # saddle refinement
    'SHRINK': 1,        # SHRINK[=factor] orbital scaling
    'SIMPLEORBITALS': 1,
    'SOLVENT': 1,
    'STEPS': 1,         # rotation steps
    'SUPRAFAC': 1,      # suprafacial pivots only
    'RMSD': 1,          # pruning threshold
    'TS': 1,
    'THREADS': 1,
}


class NEBOptions:
    '''Truthy container for NEB sub-options (reference Truthy_struct).'''

    def __init__(self, images=6, preopt=False):
        self.images = images
        self.preopt = preopt

    def __bool__(self):
        return True


class Options:
    '''Per-run options with the reference defaults
    (embedder_options.py:162-232).'''

    def __init__(self):
        self.rotation_range = 45
        self.rotation_steps = None          # set by embed-type setup
        self.rmsd = 0.5
        self.rigid = False
        self.max_confs = 1000

        self.max_clashes = 0
        self.clash_thresh = 1.5

        self.max_newbonds = 0

        self.optimization = True
        self.calculator = CALCULATOR
        self.theory_level = None
        self.solvent = None
        self.charge = 0
        self.ff_opt = FF_OPT_BOOL
        self.ff_calc = FF_CALC
        if self.ff_opt and FF_CALC:
            self.ff_level = DEFAULT_FF_LEVELS.get(FF_CALC)
        else:
            self.ff_level = None

        self.neb = False
        self.saddle = False
        self.ts = False
        self.nci = False
        self.crestnci = False
        self.shrink = False
        self.shrink_multiplier = 1
        self.metadynamics = False
        self.suprafacial = False
        self.simpleorbitals = False
        self.only_refined = False
        self.double_bond_protection = False
        self.keep_hb = False
        self.csearch_aug = False
        self.dryrun = False
        self.checkpoint_frequency = 50

        self.fix_angles_in_deformation = False

        self.kcal_thresh = 10
        self.bypass = False
        self.debug = False
        self.let = False
        self.check_structures = False
        self.noembed = False

        self.operators = []
        self.operators_dict = {}

    def __repr__(self):
        d = {k: v for k, v in sorted(vars(self).items())}
        hide_if_false = (
            'bypass', 'check_structures', 'csearch_aug', 'crestnci', 'debug',
            'let', 'metadynamics', 'nci', 'neb', 'saddle', 'ts', 'ff_opt',
            'noembed', 'keep_hb', 'operators', 'dryrun', 'shrink', 'rigid',
            'suprafacial', 'simpleorbitals', 'fix_angles_in_deformation',
            'double_bond_protection')
        for name in hide_if_false:
            if not d.get(name, True):
                d.pop(name, None)
        for name in ('kcal_thresh', 'solvent'):
            if d.get(name) is None:
                d.pop(name, None)
        pad = 1 + max(len(k) for k in d)
        return '\n'.join(f'{k}{" " * (pad - len(k))}: {d[k]}' for k in d)


class OptionSetter:
    '''
    Parses the keyword line and applies one setter method per keyword, in
    priority order (reference embedder_options.py:283-548).
    '''

    def __init__(self, embedder):
        embedder.kw_line = getattr(embedder, 'kw_line', '')
        self.embedder = embedder
        self.keywords = [w.split('=')[0].upper() if '(' not in w
                         else w.split('(')[0].upper()
                         for w in embedder.kw_line.split()]
        self.keywords_simple = [k.upper() for k in embedder.kw_line.split()]
        self.keywords_case_sensitive = embedder.kw_line.split()

        for k in self.keywords:
            if k not in KEYWORDS:
                raise SyntaxError(
                    f'Keyword {k} was not understood. Please check your syntax.')

        if self.keywords_simple:
            embedder.log('\n--> Parsed keywords, in order of execution:\n    '
                         + ' '.join(self.sorted_keywords()) + '\n')

    # ------------------------------------------------------------ helpers

    def _value_of(self, name, cast=str, case_sensitive=False):
        source = (self.keywords_case_sensitive if case_sensitive
                  else self.keywords_simple)
        kw = source[self.keywords.index(name)]
        return cast(kw.split('=')[1])

    def _paren_body(self, name):
        kw = self.keywords_case_sensitive[self.keywords.index(name)]
        return kw[len(name) + 1:-1].replace(' ', '')

    # ------------------------------------------------------------ setters

    def bypass(self, options):
        options.bypass = True
        options.optimization = False

    def calc(self, options):
        options.calculator = self._value_of('CALC').upper()

    def charge(self, options):
        options.charge = self._value_of('CHARGE', int)

    def check(self, options):
        options.check_structures = True

    def confs(self, options):
        options.max_confs = self._value_of('CONFS', int)

    def clashes(self, options):
        body = self._paren_body('CLASHES').lower()
        for piece in body.split(','):
            key, val = piece.split('=')
            if key == 'num':
                options.max_clashes = int(val)
            elif key == 'dist':
                options.clash_thresh = float(val)
            else:
                raise SyntaxError(
                    f'Syntax error in CLASHES keyword -> CLASHES({body}). '
                    f'Correct syntax looks like: CLASHES(num=3,dist=1.2)')

    def crestnci(self, options):
        options.crestnci = True

    def deep(self, options):
        # the reference's DEEP setter dereferences options.options (a
        # crash, embedder_options.py:348) and writes rotation_steps where
        # setup would clobber it; this implements the documented intent
        options.rmsd = 0.1
        options.custom_rotation_steps = 72
        options.max_clashes = 1
        options.clash_thresh = 1.4

    def debug(self, options):
        options.debug = True

    def dist(self, options):
        body = self._paren_body('DIST')
        self.embedder._set_custom_orbs(body)

    def dryrun(self, options):
        options.dryrun = True

    def ezprot(self, options):
        options.double_bond_protection = True

    def ffopt(self, options):
        value = self._value_of('FFOPT').upper()
        if value not in ('ON', 'OFF'):
            raise SyntaxError(
                "FFOPT keyword can only have value 'ON' or 'OFF' "
                "(i.e. 'FFOPT=OFF')")
        options.ff_opt = value == 'ON'

    def ffcalc(self, options):
        options.ff_calc = self._value_of('FFCALC').upper()
        if options.ff_calc == 'OPENBABEL':
            options.ff_calc = 'OB'
        if 'FFLEVEL' not in self.keywords:
            # switching calculators invalidates the old default level
            # (e.g. GFN-FF means nothing to OpenBabel)
            from tscode_tpu_torch.settings import DEFAULT_FF_LEVELS
            options.ff_level = DEFAULT_FF_LEVELS.get(options.ff_calc,
                                                     options.ff_level)

    def fflevel(self, options):
        options.ff_level = self._value_of('FFLEVEL').upper().replace('_', ' ')

    def images(self, options):
        options.images = self._value_of('IMAGES', int)

    def kcal(self, options):
        options.kcal_thresh = self._value_of('KCAL', float)

    def let(self, options):
        options.let = True

    def level(self, options):
        level = self._value_of('LEVEL', case_sensitive=True)
        options.theory_level = level.upper().replace('_', ' ') \
            .replace('[', '(').replace(']', ')')

    def mtd(self, options):
        if options.calculator != 'XTB':
            raise SyntaxError(
                'Metadynamics augmentation can only be run with the XTB '
                'calculator. Use the CALC=XTB keyword.')
        options.metadynamics = True

    def nci(self, options):
        options.nci = True

    def neb(self, options):
        options.neb = NEBOptions()
        body = self._paren_body('NEB').lower() \
            if '(' in self.keywords_case_sensitive[self.keywords.index('NEB')] else ''
        if body:
            for piece in body.split(','):
                key, val = piece.split('=')
                if key == 'images':
                    options.neb.images = int(val)
                elif key == 'preopt':
                    options.neb.preopt = val == 'true'
                else:
                    raise SyntaxError(
                        f'Syntax error in NEB keyword -> NEB({body}). '
                        f'Correct syntax looks like: NEB(images=8,preopt=true)')

    def newbonds(self, options):
        options.max_newbonds = self._value_of('NEWBONDS', int)

    def noopt(self, options):
        options.optimization = False

    def onlyrefined(self, options):
        options.only_refined = True

    def pka(self, options):
        kw = self.keywords_case_sensitive[self.keywords.index('PKA')]
        pka_string, pka = kw.split('=')
        molname = pka_string[4:-1].replace(' ', '')
        if molname in [mol.name for mol in self.embedder.objects]:
            if any(f'pka>{molname}' in op.replace(' ', '')
                   for op in self.embedder.options.operators):
                self.embedder.pka_ref = (molname, float(pka))
                return
        raise SyntaxError(
            f'{molname} must be present in the molecule lines, along with '
            f'the pka> operator. Syntax: pka(mol.xyz)=n')

    def procs(self, options):
        self.embedder.procs = self._value_of('PROCS', int)

    def refine(self, options):
        if len(self.embedder.objects) > 1:
            raise SyntaxError(
                'REFINE keyword can only be used with one multimolecular '
                f'file per run ({len(self.embedder.objects)} files found).')
        options.noembed = True

    def rigid(self, options):
        options.rigid = True

    def rmsd(self, options):
        options.rmsd = self._value_of('RMSD', float)

    def rotrange(self, options):
        options.rotation_range = self._value_of('ROTRANGE', int)

    def saddle(self, options):
        if not options.optimization:
            raise SyntaxError(
                'SADDLE keyword can only be used if optimization is on '
                '(not compatible with NOOPT).')
        options.saddle = True

    def shrink(self, options):
        options.shrink = True
        kw = self.keywords_simple[self.keywords.index('SHRINK')]
        parsed = kw.split('=')
        options.shrink_multiplier = float(parsed[1]) if len(parsed) > 1 else 1.5

    def simpleorbitals(self, options):
        options.simpleorbitals = True

    def solvent(self, options):
        from tscode_tpu_torch.solvents import SOLVENT_SYNONYMS
        solvent = self._value_of('SOLVENT').lower()
        options.solvent = SOLVENT_SYNONYMS.get(solvent, solvent)

    def steps(self, options):
        options.custom_rotation_steps = self._value_of('STEPS', int)

    def suprafac(self, options):
        # the reference sets options.suprafac, an attribute nothing reads
        # (embedder_options.py:344-345 vs embedder.py:552) — SUPRAFAC is
        # inert there; here it actually engages the pivot filter
        options.suprafacial = True

    def threads(self, options):
        self.embedder.threads = self._value_of('THREADS', int)

    def ts(self, options):
        # the reference documents TS ("various scans/saddle algorithms",
        # embedder_options.py:153) but ships no setter, so the keyword
        # raises AttributeError there — a bug. Here it routes the run to
        # first-order saddle refinement after optimization, with the
        # same NOOPT-compatibility guard as SADDLE.
        options.ts = True
        self.saddle(options)

    # ---------------------------------------------------------- dispatch

    def sorted_keywords(self):
        return sorted(self.keywords, key=KEYWORDS.get)

    def set_options(self):
        for kw in self.sorted_keywords():
            getattr(self, kw.lower())(self.embedder.options)

        if any('refine>' in op for op in self.embedder.options.operators) \
                or self.embedder.options.noembed:
            self._refine_operator_routine()

    def _refine_operator_routine(self):
        if len(self.embedder.objects) > 1:
            raise SyntaxError(
                'The refine> operator can only be used with one '
                'multimolecular file per run '
                f'({len(self.embedder.objects)} files found in input).')
        self.embedder._set_embedder_structures_from_mol()
        self.embedder.objects[0].compute_orbitals(
            override='Single' if self.embedder.options.simpleorbitals else None)
