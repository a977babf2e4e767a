"""Package metadata (reference parity: planetmapper/common.py)."""

__version__ = '0.1.0'
__author__ = 'planetmapper-tpu developers'
__url__ = 'https://github.com/planetmapper-tpu/planetmapper-tpu'
__license__ = 'MIT'
__description__ = (
    'PyTorch/CUDA planetary geometry, navigation and mapping framework'
)

CITATION_STRING = (
    'planetmapper_tpu_torch: a PyTorch/CUDA planetary geometry framework, '
    f'version {__version__}'
)
CITATION_DOI = ''
CITATION_BIBTEX = (
    '@misc{planetmapper_tpu_torch,\n'
    '  title = {planetmapper\\_tpu\\_torch: a PyTorch/CUDA planetary '
    'geometry framework},\n'
    f'  note = {{version {__version__}}},\n'
    '}'
)
