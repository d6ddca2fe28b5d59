'''
End-of-run quotes, printed by RunEmbedding.normal_termination via
write_quote (reference embedder.py:1045-1055, quotes.py). Original
selection of public-domain / widely attributed science quotes — the
reference ships its own, much larger list.
'''

quotes = [
    {'quote': 'Nothing in life is to be feared, it is only to be '
              'understood.', 'author': 'Marie Curie'},
    {'quote': 'A scientist in his laboratory is not a mere technician: '
              'he is also a child confronting natural phenomena that '
              'impress him as though they were fairy tales.',
     'author': 'Marie Curie'},
    {'quote': 'The most exciting phrase to hear in science is not '
              '"Eureka!" but "That\'s funny..."',
     'author': 'attributed to Isaac Asimov'},
    {'quote': 'If I have seen further it is by standing on the '
              'shoulders of Giants.', 'author': 'Isaac Newton'},
    {'quote': 'Nature uses only the longest threads to weave her '
              'patterns, so each small piece of her fabric reveals the '
              'organization of the entire tapestry.',
     'author': 'Richard Feynman'},
    {'quote': 'What I cannot create, I do not understand.',
     'author': 'Richard Feynman'},
    {'quote': 'The first principle is that you must not fool yourself — '
              'and you are the easiest person to fool.',
     'author': 'Richard Feynman'},
    {'quote': 'Somewhere, something incredible is waiting to be known.',
     'author': 'Carl Sagan'},
    {'quote': 'Chemistry is necessarily an experimental science: its '
              'conclusions are drawn from data, and its principles '
              'supported by evidence from facts.',
     'author': 'Michael Faraday'},
    {'quote': 'Nothing is too wonderful to be true, if it be consistent '
              'with the laws of nature.', 'author': 'Michael Faraday'},
    {'quote': 'Every attempt to employ mathematical methods in the study '
              'of chemical questions must be considered profoundly '
              'irrational. If mathematical analysis should ever hold a '
              'prominent place in chemistry — an aberration which is '
              'happily almost impossible — it would occasion a rapid and '
              'widespread degeneration of that science.',
     'author': 'Auguste Comte, 1830 (he was wrong)'},
    {'quote': 'A theory is something nobody believes, except the person '
              'who made it. An experiment is something everybody '
              'believes, except the person who made it.',
     'author': 'attributed to Albert Einstein'},
    {'quote': 'In the fields of observation chance favours only the '
              'prepared mind.', 'author': 'Louis Pasteur'},
    {'quote': 'Science knows no country, because knowledge belongs to '
              'humanity, and is the torch which illuminates the world.',
     'author': 'Louis Pasteur'},
    {'quote': 'The saddest aspect of life right now is that science '
              'gathers knowledge faster than society gathers wisdom.',
     'author': 'Isaac Asimov'},
    {'quote': 'An expert is a person who has made all the mistakes that '
              'can be made in a very narrow field.',
     'author': 'Niels Bohr'},
    {'quote': 'Prediction is very difficult, especially about the '
              'future.', 'author': 'attributed to Niels Bohr'},
    {'quote': 'I have not failed. I\'ve just found 10,000 ways that '
              'won\'t work.', 'author': 'attributed to Thomas Edison'},
    {'quote': 'We are a way for the cosmos to know itself.',
     'author': 'Carl Sagan'},
    {'quote': 'It is the function of science to discover the existence '
              'of a general reign of order in nature and to find the '
              'causes governing this order.', 'author': 'Dmitri Mendeleev'},
    {'quote': 'There is no such thing as a special category of science '
              'called applied science; there is science and its '
              'applications, which are related to one another as the '
              'fruit is related to the tree that has borne it.',
     'author': 'Louis Pasteur'},
    {'quote': 'Study hard what interests you the most in the most '
              'undisciplined, irreverent and original manner possible.',
     'author': 'Richard Feynman'},
    {'quote': 'Organic chemistry just now is enough to drive one mad. It '
              'gives me the impression of a primeval forest full of the '
              'most remarkable things.', 'author': 'Friedrich Wohler'},
    {'quote': 'The best way to have a good idea is to have a lot of '
              'ideas.', 'author': 'Linus Pauling'},
]
