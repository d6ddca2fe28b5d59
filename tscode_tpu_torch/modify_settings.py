'''
Guided calculator setup (`python -m tscode_tpu -s`).

The reference rewrites its settings.py in place
(TSCoDe's modify_settings.py:19-188); here persistent
overrides go to a JSON file that settings.py layers over its
autodetected defaults — no self-modifying code.
'''

import json
import os
import shutil

SETTINGS_PATH = os.path.join(os.path.expanduser('~'),
                             '.tscode_tpu_settings.json')

_CALCULATORS = ('XTB', 'ORCA', 'GAUSSIAN', 'MOPAC')


def load_overrides():
    if os.path.isfile(SETTINGS_PATH):
        try:
            with open(SETTINGS_PATH) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return {}
    return {}


def _ask(prompt, default, cast=str, choices=None):
    while True:
        raw = input(f'{prompt} [{default}]: ').strip()
        if not raw:
            return default
        try:
            value = cast(raw)
        except ValueError:
            print('  not a valid value, try again')
            continue
        if choices and (str(value).upper() not in choices):
            print(f'  choose one of {choices}')
            continue
        return value


def run_setup():
    '''Interactive setup; writes the overrides JSON.'''
    print('--> tscode_tpu guided setup\n')
    overrides = load_overrides()

    found = [c for c in _CALCULATORS
             if shutil.which({'XTB': 'xtb', 'ORCA': 'orca',
                              'GAUSSIAN': 'g16',
                              'MOPAC': 'mopac'}[c]) is not None]
    print(f'    calculators found on PATH: {found or "none"}\n')

    calc = _ask('Default calculator (XTB/ORCA/GAUSSIAN/MOPAC/none)',
                overrides.get('CALCULATOR') or (found[0] if found else 'none'),
                str, choices=_CALCULATORS + ('NONE',))
    overrides['CALCULATOR'] = None if str(calc).upper() == 'NONE' \
        else str(calc).upper()

    ff = _ask('Run force-field pre-optimization by default? (y/n)',
              'y' if overrides.get('FF_OPT_BOOL', True) else 'n')
    overrides['FF_OPT_BOOL'] = str(ff).lower().startswith('y')

    overrides['PROCS'] = int(_ask('Cores per QM job',
                                  overrides.get('PROCS', 4), int))
    overrides['THREADS'] = int(_ask('Concurrent QM jobs',
                                    overrides.get('THREADS', 4), int))
    overrides['MEM_GB'] = float(_ask('Memory per job (GB)',
                                     overrides.get('MEM_GB', 4), float))

    with open(SETTINGS_PATH, 'w') as f:
        json.dump(overrides, f, indent=2)
    print(f'\n--> Saved to {SETTINGS_PATH}')
