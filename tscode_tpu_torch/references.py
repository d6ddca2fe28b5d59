'''
Literature references printed by Embedder._print_references
(reference references.py:5, embedder.py:222-241). Standard public
citations for the methods this framework exposes.
'''

references = {
    'TSCoDe': ('Tampellini, N.; Galvani, G.; Bernardi, L. TSCoDe: '
               'Transition State Conformational Docker. '
               'J. Chem. Inf. Model. 2023, 63, 3878-3887.'),
    'GFN-FF': ('Spicher, S.; Grimme, S. Robust Atomistic Modeling of '
               'Materials, Organometallic, and Biochemical Systems. '
               'Angew. Chem. Int. Ed. 2020, 59, 15665-15673.'),
    'GFN2-XTB': ('Bannwarth, C.; Ehlert, S.; Grimme, S. GFN2-xTB - An '
                 'Accurate and Broadly Parametrized Self-Consistent '
                 'Tight-Binding Quantum Chemical Method. J. Chem. '
                 'Theory Comput. 2019, 15, 1652-1671.'),
    'CREST': ('Pracht, P.; Bohle, F.; Grimme, S. Automated Exploration '
              'of the Low-Energy Chemical Space with Fast Quantum '
              'Chemical Methods. Phys. Chem. Chem. Phys. 2020, 22, '
              '7169-7192.'),
    'QCP': ('Theobald, D. L. Rapid Calculation of RMSDs Using a '
            'Quaternion-Based Characteristic Polynomial. Acta Cryst. '
            '2005, A61, 478-480.'),
}
