"""
NAIF body name <-> ID code mapping.

Replaces ``spice.bods2c``/``spice.bodc2s``/``spice.bodc2n`` (reference:
planetmapper/base.py:448-482, body.py:780). The table below is the standard
public NAIF integer ID assignment (from the NAIF IDs Required Reading
document): barycenters 0-9, Sun 10, planets x99, satellites xNN, and a few
common spacecraft (negative IDs). Names loaded from kernel-pool
``NAIF_BODY_NAME``/``NAIF_BODY_CODE`` assignments extend this table.
"""

from __future__ import annotations

_BARYCENTERS = {
    'SOLAR_SYSTEM_BARYCENTER': 0, 'SSB': 0, 'SOLAR SYSTEM BARYCENTER': 0,
    'MERCURY_BARYCENTER': 1, 'MERCURY BARYCENTER': 1,
    'VENUS_BARYCENTER': 2, 'VENUS BARYCENTER': 2,
    'EARTH_BARYCENTER': 3, 'EMB': 3, 'EARTH MOON BARYCENTER': 3,
    'EARTH-MOON BARYCENTER': 3, 'EARTH BARYCENTER': 3,
    'MARS_BARYCENTER': 4, 'MARS BARYCENTER': 4,
    'JUPITER_BARYCENTER': 5, 'JUPITER BARYCENTER': 5,
    'SATURN_BARYCENTER': 6, 'SATURN BARYCENTER': 6,
    'URANUS_BARYCENTER': 7, 'URANUS BARYCENTER': 7,
    'NEPTUNE_BARYCENTER': 8, 'NEPTUNE BARYCENTER': 8,
    'PLUTO_BARYCENTER': 9, 'PLUTO BARYCENTER': 9,
    'SUN': 10,
}

_PLANETS = {
    'MERCURY': 199, 'VENUS': 299, 'EARTH': 399, 'MARS': 499,
    'JUPITER': 599, 'SATURN': 699, 'URANUS': 799, 'NEPTUNE': 899,
    'PLUTO': 999,
}

# Satellite names per system (index within the dict order is not meaningful;
# explicit IDs given). Standard NAIF assignments.
_SATELLITES = {
    # Earth
    'MOON': 301,
    # Mars
    'PHOBOS': 401, 'DEIMOS': 402,
    # Jupiter
    'IO': 501, 'EUROPA': 502, 'GANYMEDE': 503, 'CALLISTO': 504,
    'AMALTHEA': 505, 'HIMALIA': 506, 'ELARA': 507, 'PASIPHAE': 508,
    'SINOPE': 509, 'LYSITHEA': 510, 'CARME': 511, 'ANANKE': 512,
    'LEDA': 513, 'THEBE': 514, 'ADRASTEA': 515, 'METIS': 516,
    'CALLIRRHOE': 517, 'THEMISTO': 518, 'MEGACLITE': 519, 'TAYGETE': 520,
    'CHALDENE': 521, 'HARPALYKE': 522, 'KALYKE': 523, 'IOCASTE': 524,
    'ERINOME': 525, 'ISONOE': 526, 'PRAXIDIKE': 527, 'AUTONOE': 528,
    'THYONE': 529, 'HERMIPPE': 530, 'AITNE': 531, 'EURYDOME': 532,
    'EUANTHE': 533, 'EUPORIE': 534, 'ORTHOSIE': 535, 'SPONDE': 536,
    'KALE': 537, 'PASITHEE': 538, 'HEGEMONE': 539, 'MNEME': 540,
    'AOEDE': 541, 'THELXINOE': 542, 'ARCHE': 543, 'KALLICHORE': 544,
    'HELIKE': 545, 'CARPO': 546, 'EUKELADE': 547, 'CYLLENE': 548,
    'KORE': 549, 'HERSE': 550,
    # Saturn
    'MIMAS': 601, 'ENCELADUS': 602, 'TETHYS': 603, 'DIONE': 604,
    'RHEA': 605, 'TITAN': 606, 'HYPERION': 607, 'IAPETUS': 608,
    'PHOEBE': 609, 'JANUS': 610, 'EPIMETHEUS': 611, 'HELENE': 612,
    'TELESTO': 613, 'CALYPSO': 614, 'ATLAS': 615, 'PROMETHEUS': 616,
    'PANDORA': 617, 'PAN': 618, 'YMIR': 619, 'PAALIAQ': 620,
    'TARVOS': 621, 'IJIRAQ': 622, 'SUTTUNGR': 623, 'KIVIUQ': 624,
    'MUNDILFARI': 625, 'ALBIORIX': 626, 'SKATHI': 627, 'ERRIAPUS': 628,
    'SIARNAQ': 629, 'THRYMR': 630, 'NARVI': 631, 'METHONE': 632,
    'PALLENE': 633, 'POLYDEUCES': 634, 'DAPHNIS': 635, 'AEGIR': 636,
    'BEBHIONN': 637, 'BERGELMIR': 638, 'BESTLA': 639, 'FARBAUTI': 640,
    'FENRIR': 641, 'FORNJOT': 642, 'HATI': 643, 'HYRROKKIN': 644,
    'KARI': 645, 'LOGE': 646, 'SKOLL': 647, 'SURTUR': 648,
    'ANTHE': 649, 'JARNSAXA': 650, 'GREIP': 651, 'TARQEQ': 652,
    'AEGAEON': 653,
    # Uranus
    'ARIEL': 701, 'UMBRIEL': 702, 'TITANIA': 703, 'OBERON': 704,
    'MIRANDA': 705, 'CORDELIA': 706, 'OPHELIA': 707, 'BIANCA': 708,
    'CRESSIDA': 709, 'DESDEMONA': 710, 'JULIET': 711, 'PORTIA': 712,
    'ROSALIND': 713, 'BELINDA': 714, 'PUCK': 715, 'CALIBAN': 716,
    'SYCORAX': 717, 'PROSPERO': 718, 'SETEBOS': 719, 'STEPHANO': 720,
    'TRINCULO': 721, 'FRANCISCO': 722, 'MARGARET': 723, 'FERDINAND': 724,
    'PERDITA': 725, 'MAB': 726, 'CUPID': 727,
    # Neptune
    'TRITON': 801, 'NEREID': 802, 'NAIAD': 803, 'THALASSA': 804,
    'DESPINA': 805, 'GALATEA': 806, 'LARISSA': 807, 'PROTEUS': 808,
    'HALIMEDE': 809, 'PSAMATHE': 810, 'SAO': 811, 'LAOMEDEIA': 812,
    'NESO': 813, 'HIPPOCAMP': 814,
    # Pluto
    'CHARON': 901, 'NIX': 902, 'HYDRA': 903, 'KERBEROS': 904, 'STYX': 905,
}

_SPACECRAFT = {
    'HST': -48, 'HUBBLE SPACE TELESCOPE': -48,
    'JWST': -170, 'JAMES WEBB SPACE TELESCOPE': -170,
    'CASSINI': -82, 'GALILEO ORBITER': -77, 'VOYAGER 1': -31, 'VOYAGER 2': -32,
    'JUNO': -61, 'NEW HORIZONS': -98, 'SOHO': -21, 'SPITZER': -79,
    'EUROPA CLIPPER': -159, 'JUICE': -28, 'LUCY': -49,
    'MARS RECONNAISSANCE ORBITER': -74, 'MRO': -74,
    'TESS': -95, 'KEPLER': -227, 'GAIA': -123,
}

NAME_TO_ID: dict[str, int] = {**_BARYCENTERS, **_PLANETS, **_SATELLITES, **_SPACECRAFT}

# Preferred name for each ID (the name returned by ``bodc2s``): first
# occurrence wins for aliases (e.g. 'HST', matching CSPICE), except the
# barycenters, whose CSPICE canonical names are the space-separated
# forms rather than this table's underscore-first ordering (CSPICE's
# canonical name is the last zzidmap mapping per body).
ID_TO_NAME: dict[int, str] = {}
for _name, _code in NAME_TO_ID.items():
    ID_TO_NAME.setdefault(_code, _name)
ID_TO_NAME.update({
    0: 'SOLAR SYSTEM BARYCENTER',
    1: 'MERCURY BARYCENTER',
    2: 'VENUS BARYCENTER',
    3: 'EARTH BARYCENTER',
    4: 'MARS BARYCENTER',
    5: 'JUPITER BARYCENTER',
    6: 'SATURN BARYCENTER',
    7: 'URANUS BARYCENTER',
    8: 'NEPTUNE BARYCENTER',
    9: 'PLUTO BARYCENTER',
})


class BodyNotFoundError(Exception):
    """Raised when a body name cannot be resolved to a NAIF ID code."""


def _normalise(name: str) -> str:
    return ' '.join(str(name).strip().upper().split())


def bods2c(name: str | int, extra: dict[str, int] | None = None) -> int:
    """
    Translate a body name (or stringified ID) to its NAIF ID code.
    Equivalent of ``spice.bods2c``.
    """
    if isinstance(name, int):
        return name
    key = _normalise(name)
    try:
        return int(key)
    except ValueError:
        pass
    if extra and key in extra:
        return extra[key]
    if key in NAME_TO_ID:
        return NAME_TO_ID[key]
    raise BodyNotFoundError(f'Body name {name!r} not recognised')


def bodc2s(code: int, extra_names: dict[int, str] | None = None) -> str:
    """
    Translate a NAIF ID code to its canonical name; falls back to the string
    form of the code when no name is known. Equivalent of ``spice.bodc2s``.
    """
    if extra_names and code in extra_names:
        return extra_names[code]
    return ID_TO_NAME.get(code, str(code))


def bodc2n(code: int, extra_names: dict[int, str] | None = None) -> str:
    """Like :func:`bodc2s` but raises if no name exists (``spice.bodc2n``)."""
    if extra_names and code in extra_names:
        return extra_names[code]
    try:
        return ID_TO_NAME[code]
    except KeyError as exc:
        raise BodyNotFoundError(f'No name found for body ID {code}') from exc
