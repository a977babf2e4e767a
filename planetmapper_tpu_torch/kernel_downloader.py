"""
SPICE kernel download utility (parity with planetmapper/kernel_downloader.py).

Mirrors the naif.jpl.nasa.gov URL tree into the local kernel directory
(:func:`planetmapper_tpu_torch.set_kernel_path` controls the destination), with
index-page scraping, atomic temp-file downloads and tqdm progress.

Layout model: every kernel has one *tree path* (e.g.
``naif/generic_kernels/pck/pck00011.tpc``) that identifies it both under
``URL_ROOT`` and under the local kernel directory; :class:`_MirrorLayout`
owns all conversions between the three namespaces.
"""

from __future__ import annotations

import os
import re
import urllib.parse
import urllib.request

from . import utils
from .kernels.pool import get_kernel_path

URL_ROOT = 'https://naif.jpl.nasa.gov/pub/'

#: Bytes per read when streaming a download to disk.
_CHUNK_BYTES = 1 << 18

#: JPL index pages wrap the listing table in these markers, with one
#: ``<img src="/icons/...> <a href="...">`` row per entry.
_INDEX_START = '<!--start data_content-->'
_INDEX_END = '</table>'
_INDEX_ROW = re.compile(
    r'^<img src="/icons/[^"]*"[^>]*>\s*<a href="(?P<href>[^"]+)"'
)


class _MirrorLayout:
    """URL <-> tree path <-> local path conversions for the kernel mirror."""

    def resolve_tree_path(self, url_or_path: str) -> str:
        """
        The kernel-tree-relative part of a URL or local path, e.g. both
        ``https://naif.jpl.nasa.gov/pub/naif/generic_kernels/pck/`` and
        ``~/spice_kernels/naif/generic_kernels/pck/`` give
        ``naif/generic_kernels/pck``.
        """
        candidate = self._normalise(url_or_path)
        for root in (URL_ROOT, get_kernel_path()):
            root = self._normalise(root)
            if candidate.startswith(root):
                return self._normalise(os.path.relpath(candidate, root))
        raise ValueError(
            f'Cannot get kernel path from "{url_or_path}"'
        )

    def url_for(self, tree_path: str) -> str:
        return URL_ROOT + tree_path

    def local_path_for(self, url_or_path: str) -> str:
        return self.tree_path_to_local(self.resolve_tree_path(url_or_path))

    def tree_path_to_local(self, tree_path: str) -> str:
        return self._normalise(os.path.join(get_kernel_path(), tree_path))

    def exists_locally(self, url_or_path: str) -> bool:
        return os.path.exists(self.local_path_for(url_or_path))

    @staticmethod
    def _normalise(p: str) -> str:
        return os.path.normpath(os.path.expanduser(p))


_LAYOUT = _MirrorLayout()


def download_urls(*urls: str, **kwargs) -> None:
    """
    Download kernels (or index pages of kernels) from naif.jpl.nasa.gov and
    save them locally with the same directory structure. URLs whose final
    path segment has no file extension are treated as index pages.
    """
    for url in urls:
        leaf = os.path.basename(urllib.parse.urlsplit(url).path)
        handler = download_kernel if '.' in leaf else (
            download_kernels_from_webpage
        )
        handler(url, **kwargs)


def download_kernels_from_webpage(index_url: str, **kwargs) -> None:
    """Download all first-level kernels listed on an index page."""
    urls = get_kernel_paths_from_webpage(index_url)
    print(f'{len(urls)} to download from {index_url}')
    for idx, url in enumerate(urls, start=1):
        download_kernel(url, note=f'[{idx}/{len(urls)}] ', **kwargs)
    print(f'All kernels downloaded from {index_url}')
    print()


def download_kernel(
    url: str, force_download: bool = False, note: str = ''
) -> None:
    """Download a single kernel (skipped if it already exists locally)."""
    print(f'{note}Checking {_LAYOUT.resolve_tree_path(url)}')
    if _check_kernel_exists_locally(url):
        if not force_download:
            print('  OK - Kernel already exists locally')
            return
        print('  Kernel already exists, downloading anyway')
    local_path = _convert_url_to_local_path(url)
    print(f'  Downloading to {local_path}')
    download_file(url, local_path)
    print('    Done')


def get_kernel_paths_from_webpage(index_url: str) -> list[str]:
    """
    Kernel URLs scraped from a naif.jpl.nasa.gov index page (fragile by
    nature - depends on the JPL page format, see ``_INDEX_ROW``).
    """
    if not index_url.startswith(URL_ROOT):
        raise AssertionError(f'URL must begin with {URL_ROOT}')
    page = urllib.request.urlopen(index_url).read().decode()
    try:
        listing = page.split(_INDEX_START, 1)[1].split(_INDEX_END, 1)[0]
    except IndexError:
        raise ValueError(
            f'{index_url} does not look like a JPL kernel index page'
        ) from None
    found = []
    for line in listing.splitlines():
        m = _INDEX_ROW.match(line)
        if m is not None and '.' in m.group('href'):
            found.append(f'{index_url}/{m.group("href")}')
    return found


def download_file(url: str, local_path: str) -> None:
    """
    Download a file, writing to a temp path and atomically renaming so
    partial downloads never corrupt the kernel directory.
    """
    utils.check_path(local_path)
    temp_path = local_path + '.temp'
    try:
        with urllib.request.urlopen(url) as response:
            total = int(response.headers.get('Content-Length') or 0) or None
            with open(temp_path, 'wb') as out, _progress_bar(total) as bar:
                while True:
                    chunk = response.read(_CHUNK_BYTES)
                    if not chunk:
                        break
                    out.write(chunk)
                    bar.update(len(chunk))
    except BaseException:
        if os.path.exists(temp_path):
            os.remove(temp_path)
        raise
    os.replace(temp_path, local_path)


def _progress_bar(total: int | None):
    import tqdm

    return tqdm.tqdm(
        total=total, unit_scale=True, unit='B', unit_divisor=1024
    )


# Conversion helpers kept as module-level functions: the test suite (and
# reference parity) patch/exercise these names directly.
def _check_kernel_exists_locally(url: str) -> bool:
    return _LAYOUT.exists_locally(url)


def _convert_url_to_local_path(url: str) -> str:
    return _LAYOUT.local_path_for(url)


def _get_kernel_path(p: str) -> str:
    return _LAYOUT.resolve_tree_path(p)


def _kernel_path_to_url(kp: str) -> str:
    return _LAYOUT.url_for(kp)


def _kernel_path_to_local_path(kp: str) -> str:
    return _LAYOUT.tree_path_to_local(kp)
