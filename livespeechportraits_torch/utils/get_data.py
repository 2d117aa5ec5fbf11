"""Dataset/subject-pack downloader (reference util/get_data.py:11-110).

The port's copy of ``livespeechportraits_tpu/utils/get_data.py``: the
reference's pix2pix/CycleGAN-era ``GetData`` helper, which scrapes an index
page for .zip/.tar.gz archives, downloads one and extracts it, on the
standard library only (urllib + html.parser instead of requests +
BeautifulSoup), with a non-interactive selection mode and an optional
checksum.  The tests drive the listing, download and extraction with the
network mocked (tests/test_torch_aux.py).  On a connected machine:

    >>> gd = GetData(technique="pix2pix")
    >>> path = gd.get(save_path="./datasets", choice=0)
"""

from __future__ import annotations

import hashlib
import os
import tarfile
import urllib.request
from html.parser import HTMLParser
from os.path import basename, isdir, join
from typing import List, Optional
from zipfile import ZipFile

URL_DICT = {
    # reference util/get_data.py:28-31
    "pix2pix": "http://efrosgans.eecs.berkeley.edu/pix2pix/datasets/",
    "cyclegan": "https://people.eecs.berkeley.edu/~taesung_park/CycleGAN/datasets",
}

ARCHIVE_SUFFIXES = (".zip", ".tar.gz")


class _LinkParser(HTMLParser):
    """Collect <a href> targets whose text names an archive."""

    def __init__(self) -> None:
        super().__init__()
        self._in_a = False
        self._text: List[str] = []
        self.links: List[str] = []

    def handle_starttag(self, tag, attrs):
        if tag == "a" and any(k == "href" for k, _ in attrs):
            self._in_a = True
            self._text = []

    def handle_data(self, data):
        if self._in_a:
            self._text.append(data)

    def handle_endtag(self, tag):
        if tag == "a" and self._in_a:
            self._in_a = False
            text = "".join(self._text).strip()
            if text.endswith(ARCHIVE_SUFFIXES):
                self.links.append(text)


def parse_archive_options(html: str) -> List[str]:
    """Archive names linked from an index page (get_data.py:40-44)."""
    p = _LinkParser()
    p.feed(html)
    return p.links


def extract_archive(path: str, dest: str) -> None:
    """Unpack a .zip or .tar.gz next to the download (get_data.py:70-78)."""
    if path.endswith(".tar.gz"):
        with tarfile.open(path) as obj:
            obj.extractall(dest, filter="data")
    elif path.endswith(".zip"):
        with ZipFile(path) as obj:
            obj.extractall(dest)
    else:
        raise ValueError(f"unsupported archive type: {path!r}")


class GetData:
    """Scriptable archive downloader (reference GetData parity).

    technique: 'pix2pix' | 'cyclegan', or pass url=... directly for any
    index page (e.g. a mirror hosting LiveSpeechPortraits subject packs).
    """

    def __init__(self, technique: str = "cyclegan", verbose: bool = True,
                 url: Optional[str] = None):
        self.url = url or URL_DICT[technique.lower()]
        self._verbose = verbose

    def _print(self, text: str) -> None:
        if self._verbose:
            print(text)

    def options(self) -> List[str]:
        with urllib.request.urlopen(self.url) as r:
            html = r.read().decode("utf-8", "replace")
        return parse_archive_options(html)

    def get(self, save_path: str, choice: Optional[int] = None,
            dataset: Optional[str] = None,
            sha256: Optional[str] = None) -> str:
        """Download one archive and extract it under save_path.

        choice: index into options() (non-interactive; the reference
        prompts on stdin, get_data.py:47-55 - pass None to keep that
        behaviour).  dataset: archive name directly, skipping the index
        fetch.  sha256: optional integrity check of the downloaded bytes.
        Returns the extracted dataset directory.
        """
        if dataset is None:
            opts = self.options()
            if choice is None:
                for i, o in enumerate(opts):
                    self._print(f"{i}: {o}")
                choice = int(input("\nPlease enter the number of the "
                                   "dataset above you wish to download:"))
            dataset = opts[choice]
        url = self.url.rstrip("/") + "/" + dataset

        if not isdir(save_path):
            os.makedirs(save_path)
        archive = join(save_path, basename(dataset))
        self._print(f"Downloading data from {url}")
        h = hashlib.sha256()
        with urllib.request.urlopen(url) as r, open(archive, "wb") as f:
            # stream in chunks: subject archives are multi-GB and r.read()
            # would buffer the whole file (2x at the write) in memory
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
                f.write(chunk)
        if sha256 is not None:
            got = h.hexdigest()
            if got != sha256:
                os.remove(archive)
                raise ValueError(f"checksum mismatch for {dataset}: "
                                 f"expected {sha256}, got {got}")
        self._print("Extracting data.")
        extract_archive(archive, save_path)
        os.remove(archive)

        for suf in ARCHIVE_SUFFIXES:
            if dataset.endswith(suf):
                return join(save_path, basename(dataset)[: -len(suf)])
        return save_path
