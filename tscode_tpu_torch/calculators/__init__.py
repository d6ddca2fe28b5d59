'''External QM/FF calculator adapters (host-side subprocess dispatch).'''
