'''
Persistent run defaults (reference TSCoDe's settings.py:22-71).

Unlike the reference — which hard-codes values edited in place by a guided
setup — calculators are auto-detected from the PATH at import, so a box
without xtb still runs every pure-geometry path (NOOPT/BYPASS, embeds,
pruning) and clearly reports what is missing otherwise.
'''

import os
import shutil

# external binaries, probed once
XTB_AVAILABLE = shutil.which('xtb') is not None
CREST_AVAILABLE = shutil.which('crest') is not None
ORCA_AVAILABLE = shutil.which('orca') is not None
GAUSSIAN_COMMAND = next((g for g in ('g16', 'g09') if shutil.which(g)), None)
MOPAC_AVAILABLE = shutil.which('MOPAC2016.exe') is not None or \
    shutil.which('mopac') is not None
OBABEL_AVAILABLE = shutil.which('obabel') is not None

# whether to run the force-field optimization step by default
FF_OPT_BOOL = XTB_AVAILABLE

# force-field calculator and default levels
FF_CALC = 'XTB' if XTB_AVAILABLE else None
DEFAULT_FF_LEVELS = {
    'XTB': 'GFN-FF',
    'GAUSSIAN': 'UFF',
    'OB': 'UFF',
}

# default (semiempirical+) calculator
CALCULATOR = ('XTB' if XTB_AVAILABLE else
              'ORCA' if ORCA_AVAILABLE else
              'GAUSSIAN' if GAUSSIAN_COMMAND else
              'MOPAC' if MOPAC_AVAILABLE else None)

DEFAULT_LEVELS = {
    'XTB': 'GFN2-xTB',
    'MOPAC': 'PM7',
    'ORCA': 'PM3',
    'GAUSSIAN': 'PM6',
}

COMMANDS = {
    'XTB': 'xtb',
    'MOPAC': 'MOPAC2016.exe',
    'ORCA': 'orca',
    'GAUSSIAN': GAUSSIAN_COMMAND or 'g16',
}

# parallelization defaults (overridable per run / via env)
PROCS = int(os.environ.get('TSCODE_TPU_PROCS', 0)) or None
THREADS = int(os.environ.get('TSCODE_TPU_THREADS', 0)) or None
MEM_GB = float(os.environ.get('TSCODE_TPU_MEM_GB', 4))

# layer persistent user overrides from `python -m tscode_tpu -s`
try:
    from tscode_tpu_torch.modify_settings import load_overrides as _load_overrides
    _ov = _load_overrides()
    CALCULATOR = _ov.get('CALCULATOR', CALCULATOR)
    FF_OPT_BOOL = _ov.get('FF_OPT_BOOL', FF_OPT_BOOL) and FF_CALC is not None
    PROCS = _ov.get('PROCS', PROCS)
    THREADS = _ov.get('THREADS', THREADS)
    MEM_GB = _ov.get('MEM_GB', MEM_GB)
except ImportError:          # pragma: no cover - circular-import guard
    pass
