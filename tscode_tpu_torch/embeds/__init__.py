'''Embed machinery of the port.'''
