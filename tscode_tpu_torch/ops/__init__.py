'''Batched device ops of the port: geometry, clash screen, RMSD prune.'''
