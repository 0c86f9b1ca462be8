"""SED2012 dataset ingest (MediaEval Social Event Detection 2012).

Re-implements reference data_loader.py:9-188 with a streaming ingest:
the reference DOM-parses the full ~400MB metadata XML into memory (reference
data_loader.py:131, its slowest I/O per SURVEY.md §3.1); here we stream with
``xml.etree.ElementTree.iterparse`` and clear elements as we go, so peak host
memory is one photo record.

Output schema and label semantics match the reference exactly:
columns [id, datetaken, dateupload, latitude, longitude, title, description,
tags, username, event_id, is_event, event_type]; timestamps converted with the
same '0000-00-00 ...' sentinel replacement; text cleaned with the same regex
pipeline.
"""
from __future__ import annotations

import datetime
import os
import re
import time
import xml.etree.ElementTree as ET

import numpy as np
import pandas as pd

DATASET_DIR = "dataset/sed2012"


_HTML_RE = re.compile(r"<.*?>")
_PUNCT_RE = re.compile(r"[^a-zA-Z0-9\s]")
_WS_RE = re.compile(r"\s+")


def clean_text(text: str) -> str:
    """Reference text normalization (data_loader.py:180-185).  Patterns are
    precompiled: this runs per title/description/tag over the whole corpus
    (~250k calls at 50k records) and the re-module cache lookups alone were
    ~25% of its profile."""
    text = text.strip()
    text = _HTML_RE.sub(" ", text)
    text = _PUNCT_RE.sub(" ", text)
    text = _WS_RE.sub(" ", text)
    return text.strip().lower()


def convert_to_timestamp(x: str) -> float:
    """Reference timestamp conversion (data_loader.py:187-188).

    The reference hard-requires fractional seconds ('%Y-%m-%d %H:%M:%S.%f') —
    which its own sentinel replacement '1970-01-01 00:00:00' doesn't satisfy,
    so it would crash on any zeroed timestamp.  We accept both forms.
    """
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S"):
        try:
            return time.mktime(datetime.datetime.strptime(x, fmt).timetuple())
        except ValueError:
            continue
    raise ValueError(f"unparseable timestamp: {x!r}")


def convert_timestamp_column(values) -> np.ndarray:
    """Vectorized ``convert_to_timestamp`` over a whole column.

    ``time.mktime`` interprets the parsed struct_tm in the HOST's local
    timezone and drops fractional seconds (``timetuple()``).  Under UTC
    (``time.timezone == 0`` and no DST rule) mktime is exactly "seconds since
    epoch of the wall-clock fields", so the column vectorizes as
    ``pd.to_datetime`` + floor-to-seconds — ~30x the 340k-row apply() the
    per-row path costs at corpus scale.  On a non-UTC host we keep the
    reference-exact per-row conversion (DST-gap resolution in mktime has no
    faithful vectorized equivalent).  Raises ValueError on any unparseable
    entry, like the scalar path.
    """
    if time.timezone != 0 or time.daylight:
        return np.fromiter((convert_to_timestamp(v) for v in values),
                           np.float64, count=len(values))
    s = pd.Series(values, dtype=object)
    # pandas' %f accepts up to 9 fractional digits where strptime's caps
    # at 6 — reject over-long FRACTIONS like the scalar path (review r5:
    # a fixed 26-char length check missed 7-9 digit fractions on
    # unpadded date/time fields, making accept/reject host-dependent)
    frac = s.str.extract(r"\.(\d+)\s*$", expand=False)
    too_long = frac.str.len().fillna(0) > 6
    if too_long.any():
        raise ValueError(f"unparseable timestamp: {s[too_long].iloc[0]!r}")
    dt = pd.to_datetime(s, format="%Y-%m-%d %H:%M:%S.%f", errors="coerce")
    miss = dt.isna()
    if miss.any():
        dt2 = pd.to_datetime(s[miss], format="%Y-%m-%d %H:%M:%S",
                             errors="coerce")
        dt = dt.copy()
        dt[miss] = dt2
        miss = dt.isna()
    secs = dt.to_numpy().astype("datetime64[s]")     # mktime drops .%f
    out = (secs - np.datetime64(0, "s")).astype(np.float64)
    if miss.any():
        # rows pandas cannot represent (datetime64[ns] range ends at 2262)
        # or parse: the SCALAR path is the semantics of record — it either
        # converts them (valid far-future dates) or raises the same error
        # it always did (review r5: coerce turned valid dates into errors)
        for i in np.flatnonzero(miss.to_numpy()):
            out[i] = convert_to_timestamp(s.iloc[i])
    return out


_LIST_STR_DTYPE: object = False          # unprobed sentinel


def _list_str_dtype():
    """The dtype pandas infers for a list-of-str column IF it is a string
    dtype (pandas >= 3 / future string inference), else None — callers keep
    list columns on None so the native and iterparse ingest paths build
    dtype-identical frames on any pandas version."""
    global _LIST_STR_DTYPE
    if _LIST_STR_DTYPE is False:
        dtype = pd.Series(["a"]).dtype
        _LIST_STR_DTYPE = None if dtype == np.dtype(object) else dtype
    return _LIST_STR_DTYPE


def parse_ground_truth(lines, ground_truth: dict, class_counter: int = 1) -> int:
    """One ground-truth txt: each line lists a comma-separated photo-id group
    forming one event class (reference data_loader.py:115-128).  Returns the
    next unused class id."""
    counter = class_counter
    for line in lines:
        ids = [tok.strip() for tok in line.strip().split(",") if tok.strip()]
        if not ids:
            continue
        for pid in ids:
            ground_truth[pid] = counter
        counter += 1
    return counter


def load_sed2012_dataset(dataset_dir: str = DATASET_DIR,
                         max_records: int | None = None,
                         skip_records: int = 0) -> pd.DataFrame:
    """Full reference loader (data_loader.py:9-50): 3 ground-truth files ->
    photoID->eventID map; streamed XML metadata parse; derived is_event /
    event_type labels; timestamp conversion.

    ``max_records``/``skip_records`` bound and offset the streamed XML parse
    (the corpus is ~400MB / ~167k photos): validate end-to-end on the first
    N records immediately, or resume a partial ingest from record
    ``skip_records`` — the iterparse stream stops early, so a bounded load
    touches only the prefix of the file.
    """
    metadata_file = os.path.join(dataset_dir, "sed2012_metadata.xml")
    ground_truth: dict[str, int] = {}
    ranges = {}
    lo = 1
    for name, fname in (("technical", "technical_events.txt"),
                        ("soccer", "soccer_events.txt"),
                        ("indignados", "indignados_events.txt")):
        with open(os.path.join(dataset_dir, fname)) as f:
            nxt = parse_ground_truth(f.readlines(), ground_truth,
                                     class_counter=lo)
        ranges[name] = (lo, nxt - 1)
        lo = nxt

    df = parse_metadata(metadata_file, ground_truth,
                        max_records=max_records, skip_records=skip_records)

    min_tech, max_tech = ranges["technical"]
    _, max_ind = ranges["indignados"]
    min_soc, max_soc = ranges["soccer"]
    min_ind = ranges["indignados"][0]

    eid = df["event_id"].to_numpy()
    df["is_event"] = np.where((eid >= min_tech) & (eid <= max_ind), 1, 0)
    df["event_type"] = np.select(
        [(eid >= min_tech) & (eid <= max_tech),
         (eid >= min_soc) & (eid <= max_soc),
         (eid >= min_ind) & (eid <= max_ind)],
        [1, 2, 3], default=0)

    for col in ("datetaken", "dateupload"):
        df[col] = convert_timestamp_column(
            df[col].replace(["0000-00-00 00:00:00"], "1970-01-01 00:00:00")
            .tolist())
    return df


def parse_metadata(metadata_path: str, ground_truth: dict,
                   max_records: int | None = None,
                   skip_records: int = 0,
                   use_native: bool | None = None) -> pd.DataFrame:
    """Streaming equivalent of reference get_modalities (data_loader.py:130-178).

    ``skip_records`` photos are skipped (cheaply: cleared without field
    extraction) and at most ``max_records`` are parsed, enabling bounded
    validation runs and chunked/resumable ingest of the real corpus.

    ``use_native`` selects the C++ scanner (native/sed2012_parser.cpp),
    which extracts fields AND runs title/description/tags through its own
    ``clean_text_ref`` — a deliberate second implementation of this module's
    ``clean_text`` (the Python regex pipeline was the ingest wall at corpus
    scale).  The two are kept in lock-step by parity tests (identical
    DataFrames, including a fuzz test through a full XML round trip): edit
    one, run tests/test_sed2012_loader.py, fix the other.  Labels/float
    parsing happen here either way.  None = auto: native when the library
    builds, overridable with MUSED_TPU_NO_NATIVE_PARSER=1.  Memory trade:
    the native scanner reads the whole file (<= ~3x corpus size peak;
    measured 0.75 GB RSS on a 96 MB corpus) for a ~3.8x end-to-end speedup;
    the Python iterparse fallback streams at O(one record) — prefer it via
    the env var on memory-constrained hosts.  The threaded scan
    (MUSED_TPU_PARSER_THREADS) stitches chunk outputs by move, adding at
    most ~one chunk of transient memory over the sequential bound.
    """
    if use_native is None:
        use_native = os.environ.get("MUSED_TPU_NO_NATIVE_PARSER", "") != "1"
    if use_native:
        from mused_tpu import native
        # clean=True: title/description/tags run through the C++ clean_text
        # reimplementation (native/sed2012_parser.cpp clean_text_ref; parity
        # tests pin equality with this module's clean_text) — the Python
        # regex pipeline was the ingest wall at corpus scale
        cols = native.parse_sed2012(metadata_path,
                                    skip_records=skip_records,
                                    max_records=max_records, clean=True,
                                    arrow_strings=True)
        if cols is not None:
            tag_lists, ti = [], 0
            for c in cols["tag_counts"]:
                tag_lists.append(cols["tags"][ti:ti + c])
                ti += c

            def _str_col(v):
                # pyarrow arrays (title/description fast path) wrap into
                # pandas' inferred string dtype without materializing
                # Python strings; plain lists take pandas' normal
                # inference (identical result — the fixture parity tests
                # compare whole frames).  On pandas < 3 (lists infer
                # object dtype) the arrow array is converted back to a
                # list so native and iterparse frames stay identical.
                if isinstance(v, list):
                    return v
                dtype = _list_str_dtype()
                return v.to_pylist() if dtype is None else pd.array(
                    v, dtype=dtype)

            df = pd.DataFrame({
                "id": cols["id"],
                "datetaken": [s.strip() for s in cols["taken"]],
                "dateupload": [s.strip() for s in cols["uploaded"]],
                # one try covers BOTH floats in the reference (data_loader
                # :144-149) — an unparseable latitude voids the longitude
                # and vice versa (a literal "nan" attribute, which float()
                # would accept, is indistinguishable here; never occurs)
                "latitude": np.where(np.isnan(cols["lon"]), np.nan,
                                     cols["lat"]),
                "longitude": np.where(np.isnan(cols["lat"]), np.nan,
                                      cols["lon"]),
                "title": _str_col(cols["title"]),
                "description": _str_col(cols["description"]),
                "tags": tag_lists,
                "username": [s.strip() for s in cols["username"]],
                "event_id": [ground_truth.get(p, 0) for p in cols["id"]],
            })
            df["id"] = df["id"].astype(int)
            return df
    rows = []
    context = ET.iterparse(metadata_path, events=("start", "end"))
    root = None
    seen = 0
    for event, elem in context:
        if event == "start":
            if root is None:
                root = elem
            continue
        if elem.tag != "photo":
            continue
        seen += 1
        if seen <= skip_records:
            elem.clear()
            if root is not None:
                root.clear()
            continue
        if max_records is not None and len(rows) >= max_records:
            break
        pid = elem.get("id", "")
        event_id = ground_truth.get(pid, 0)
        datetaken = (elem.get("dateTaken") or "").strip()
        dateupload = (elem.get("dateUploaded") or "").strip()
        username = (elem.get("username") or "").strip()
        loc = elem.find("location")
        try:
            latitude = float(loc.get("latitude"))
            longitude = float(loc.get("longitude"))
        except (AttributeError, TypeError, ValueError):
            latitude, longitude = np.nan, np.nan
        tags = [clean_text(t.text) for t in elem.findall(".//tag")
                if t.text is not None]
        title_el = elem.find("title")
        title = clean_text(title_el.text) if (title_el is not None and title_el.text) else ""
        desc_el = elem.find("description")
        description = clean_text(desc_el.text) if (desc_el is not None and desc_el.text) else ""
        rows.append([pid, datetaken, dateupload, latitude, longitude,
                     title, description, tags, username, event_id])
        elem.clear()
        if root is not None:
            root.clear()    # drop processed children so memory stays O(1)

    df = pd.DataFrame(rows, columns=["id", "datetaken", "dateupload", "latitude",
                                     "longitude", "title", "description", "tags",
                                     "username", "event_id"])
    df["id"] = df["id"].astype(int)
    return df


def prepare_modalities(df: pd.DataFrame, subset_size: int = 10000,
                       sort_by_uploaded: bool = True, event_types: bool = False,
                       binary: bool = False, noise_rate: float = 0.95,
                       seed: int = 0):
    """Label-mode selection + seeded noise/event subsampling + modality split
    (reference data_loader.py:52-113, replicated exactly: same RNG stream,
    same sampling arithmetic, same output layout)."""
    if binary:
        labels = df["is_event"].to_numpy()
    elif event_types:
        labels = df["event_type"].to_numpy()
    else:
        labels = df["event_id"].to_numpy()

    subset_size = min(subset_size, len(df))
    rng = np.random.default_rng(seed=seed)

    if 0 <= noise_rate < 1.0:
        noise_indices = np.where(labels == 0)[0]
        event_indices = np.where(labels > 0)[0]
        num_events = min(int((1 - noise_rate) * subset_size), len(event_indices))
        num_noise = subset_size - num_events
        sampled_noise = rng.choice(noise_indices, num_noise, replace=False)
        sampled_events = rng.choice(event_indices, num_events, replace=False)
        sampled = np.sort(np.concatenate([sampled_noise, sampled_events]))
        df = df.iloc[sampled]

    if sort_by_uploaded:
        df = df.sort_values(by="dateupload")

    time_modality = df[["datetaken", "dateupload"]].to_numpy()
    location_modality = df[["latitude", "longitude"]].to_numpy()
    username_modality = df[["username"]].to_numpy()
    tags_modality = df[["tags"]].to_numpy()
    text_modality = df[["title", "description"]].to_numpy()

    if binary:
        labels = df["is_event"].to_numpy()
    elif event_types:
        labels = df["event_type"].to_numpy()
    else:
        labels = df["event_id"].to_numpy()

    assert (time_modality.shape[0] == location_modality.shape[0]
            == text_modality.shape[0] == labels.shape[0])

    return ([location_modality, time_modality, username_modality,
             tags_modality, text_modality],
            ["location", "time", "username", "tags", "text"], labels)
