"""The port's copy of `bisinger_tpu/data/text/text_norm.py`.

Chinese non-standard-word (NSW) text normalization.

Behavioural equivalent of the reference's `train_bisinger/utils/text_norm.py`
(vendored chn_text_norm, 795 LoC; used by the ZH txt processors at
`data_gen/tts/txt_processors/zh*.py`): rewrites dates, money, phone
numbers, fractions, percentages, quantified cardinals, long digit
strings and remaining numbers into spoken hanzi, then strips CN/EN
punctuation to spaces. Conformance is locked by
`tests/test_text_processors.py::test_nsw_reference_conformance`, which
runs BOTH normalizers over an NSW corpus and diffs the outputs.

Number-conversion semantics matched exactly (`text_norm.py:324-424`):
  - mid numbering system (十/百/千 within 4-digit groups, 万=1e4, 亿=1e8),
    recursive largest-unit split, 零 inserted for stripped zero runs;
  - 两 substitution: a digit 2 whose NEXT symbol is a unit of power>1
    (百/千/万/亿) and whose PREVIOUS symbol is a unit of power>1 or the
    number start becomes 两 (so 两千/两百/两万, but 二十 and 零二百);
  - leading 一十 -> 十; decimals read digit-by-digit after 点, with 零
    prepended when the integer part is empty;
  - digit-string mode (phone numbers, ids, 4..32-digit runs) reads
    digit-by-digit with 一 (not 幺) and no units.

Self-contained (no external deps); pure host-side preprocessing.
"""

from __future__ import annotations

import re
import string
from typing import List, Tuple

_DIGITS = "零一二三四五六七八九"

# mid numbering system: in-group units + group units (power = #zeros)
_UNITS: List[Tuple[str, int]] = [("亿", 8), ("万", 4), ("千", 3), ("百", 2), ("十", 1)]
_UNIT_BY_POWER = {p: u for u, p in _UNITS}

# symbol stream: ("d", digit_value) | ("u", power)
_Sym = Tuple[str, int]


def _int_symbols(s: str) -> List[_Sym]:
    """Recursive largest-unit decomposition of an integer string into
    digit/unit symbols, inserting one 零 for any skipped zero run."""
    stripped = s.lstrip("0")
    if not stripped:
        return []
    if len(stripped) == 1:
        out: List[_Sym] = []
        if len(s) != len(stripped):
            out.append(("d", 0))
        out.append(("d", int(stripped)))
        return out
    power = next(p for _, p in _UNITS if p < len(stripped))
    head, tail = s[:-power], stripped[-power:]
    return _int_symbols(head) + [("u", power)] + _int_symbols(tail)


def num_to_hanzi(number: str, use_units: bool = True, alt_two: bool = True) -> str:
    """'1200' -> '一千两百', '20202' -> '两万零二百零二', '34.5' ->
    '三十四点五'; with use_units=False, digit-by-digit ('0595' ->
    '零五九五'). Mirrors the reference `num2chn` defaults."""
    int_part, dot, dec_part = number.partition(".")
    if use_units and len(int_part) > 1:
        syms = _int_symbols(int_part)
    else:
        syms = [("d", int(c)) for c in int_part]
    if dot:
        syms.append(("pt", 0))
        syms += [("d", int(c)) for c in dec_part]

    if alt_two:
        for i, (kind, v) in enumerate(syms):
            if kind != "d" or v != 2:
                continue
            nxt = syms[i + 1] if i + 1 < len(syms) else None
            prv = syms[i - 1] if i > 0 else None
            next_big_unit = nxt is not None and nxt[0] == "u" and nxt[1] != 1
            prev_ok = prv is None or (prv[0] == "u" and prv[1] != 1)
            if next_big_unit and prev_ok:
                syms[i] = ("liang", 2)

    parts = []
    for kind, v in syms:
        if kind == "d":
            parts.append(_DIGITS[v])
        elif kind == "u":
            parts.append(_UNIT_BY_POWER[v])
        elif kind == "liang":
            parts.append("两")
        else:
            parts.append("点")
    result = "".join(parts)
    if result.startswith("点"):
        result = _DIGITS[0] + result
    if len(result) >= 2 and result[0] == "一" and result[1] == "十":
        result = result[1:]
    return result


# ---- standalone reading utilities (kept for general use) -----------------

def digit_reading(s: str, telephone: bool = False) -> str:
    """Digit-by-digit ('2024' -> '二零二四'); telephone=True uses the
    spoken 幺 for 1. NOTE: the reference pipeline reads phone numbers
    with plain 一 — the conformant path calls num_to_hanzi(use_units=False)."""
    return "".join(
        "幺" if ch == "1" and telephone else _DIGITS[int(ch)] for ch in s
    )


def cardinal_reading(s: str) -> str:
    """Plain cardinal without the 两 substitution ('2024' ->
    '二千零二十四'). The NSW pipeline itself uses the reference's
    alt_two form (两千零二十四)."""
    s = s.lstrip("0") or "0"
    if len(s) > 16:
        return digit_reading(s)
    return num_to_hanzi(s, alt_two=False)


def decimal_reading(s: str) -> str:
    """'3.14' -> '三点一四' (no 两 substitution)."""
    return num_to_hanzi(s, alt_two=False)


_FULLWIDTH = {chr(0xFF01 + i): chr(0x21 + i) for i in range(0x5E)}
_FULLWIDTH["　"] = " "


def fullwidth_to_halfwidth(text: str) -> str:
    return "".join(_FULLWIDTH.get(c, c) for c in text)


# ---- NSW pipeline (category regexes mirror `text_norm.py:608-702`) -------

# money units / quantifiers: same literal sets as the reference
# (`text_norm.py:44-52`) — these are data contracts, not code
_CURRENCY_UNITS = (
    "((亿|千万|百万|万|千|百)|(亿|千万|百万|万|千|百|)元|(亿|千万|百万|万|千|百|)块|角|毛|分)"
)
_QUANTIFIERS = (
    "(匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|支|袭|辆|挑|担|颗|壳|窠|曲|墙|群|腔|"
    "砣|座|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|队|单|双|对|出|口|头|脚|板|跳|枝|件|贴|"
    "针|线|管|名|位|身|堂|课|本|页|家|户|层|丝|毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|(千|毫|微)克|"
    "毫|厘|分|寸|尺|丈|里|寻|常|铺|程|(千|分|厘|毫|微)米|撮|勺|合|升|斗|石|盘|碗|碟|叠|桶|笼|盆|"
    "盒|杯|钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|煲|啖|袋|钵|年|月|日|季|刻|时|周|天|秒|分|旬|"
    "纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|颗|幢|堆|条|根|支|道|面|片|张|颗|块)"
)
_CN_PUNC = (
    "！？｡。"
    "＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃《》「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏"
)

_RE_DATE = re.compile(r"\D+((([089]\d|(19|20)\d{2})年)?(\d{1,2}月(\d{1,2}[日号])?)?)")
_RE_MONEY = re.compile(
    r"\D+((\d+(\.\d+)?)[多余几]?" + _CURRENCY_UNITS + r"(\d" + _CURRENCY_UNITS + r"?)?)"
)
_RE_MOBILE = re.compile(r"\D((\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8})\D")
_RE_LANDLINE = re.compile(r"\D((0(10|2[1-3]|[3-9]\d{2})-?)?[1-9]\d{6,7})\D")
_RE_FRACTION = re.compile(r"(\d+/\d+)")
_RE_PERCENT = re.compile(r"(\d+(\.\d+)?%)")
_RE_QUANTIFIED = re.compile(r"(\d+(\.\d+)?)[多余几]?" + _QUANTIFIERS)
_RE_DIGIT_RUN = re.compile(r"(\d{4,32})")
_RE_NUMBER = re.compile(r"(\d+(\.\d+)?)")
_RE_LETTER_TWO = re.compile(r"(([a-zA-Z]+)二([a-zA-Z]+))")
_NUM_IN = re.compile(r"(\d+(\.\d+)?)")


def _date_to_hanzi(date: str) -> str:
    """Year digit-by-digit, month/day as cardinals ('09年3月15号' ->
    '零九年三月十五号')."""
    year = month = day = ""
    rest = date.strip()
    if "年" in rest:
        y, rest = rest.split("年", 1)
        year = num_to_hanzi(y, use_units=False, alt_two=False) + "年"
    if rest:
        if "月" in rest:
            mth, d = rest.split("月", 1)
            month = num_to_hanzi(mth) + "月"
            if d:
                day = num_to_hanzi(d[:-1]) + d[-1]
        elif rest[-1:] in ("日", "号"):
            day = num_to_hanzi(rest[:-1]) + rest[-1]
    return year + month + day


def _money_to_hanzi(money: str) -> str:
    """Convert every number inside a money expression, keeping units."""
    return _NUM_IN.sub(lambda m: num_to_hanzi(m.group(1)), money)


def _phone_to_hanzi(phone: str, fixed: bool) -> str:
    seps = "-" if fixed else " "
    parts = phone.strip("+").split(seps)
    return "".join(num_to_hanzi(p, use_units=False, alt_two=False) for p in parts if p)


class NSWNormalizer:
    """Pipeline mirroring the reference category order
    (`utils/text_norm.py:608-714`): date -> money -> mobile/landline
    phone -> fraction -> percentage -> quantified cardinal -> digit run
    -> remaining number -> letter二letter restore -> punctuation strip."""

    def __init__(self, text: str):
        self.text = text

    def normalize(self, remove_punc: bool = True) -> str:
        # sentinels so the \D look-around anchors also fire at the ends
        t = "^" + fullwidth_to_halfwidth(self.text) + "$"

        for m in _RE_DATE.findall(t):
            if m[0]:
                t = t.replace(m[0], _date_to_hanzi(m[0]), 1)
        for m in _RE_MONEY.findall(t):
            t = t.replace(m[0], _money_to_hanzi(m[0]), 1)
        for m in _RE_MOBILE.findall(t):
            t = t.replace(m[0], _phone_to_hanzi(m[0], fixed=False), 1)
        for m in _RE_LANDLINE.findall(t):
            t = t.replace(m[0], _phone_to_hanzi(m[0], fixed=True), 1)
        for m in _RE_FRACTION.findall(t):
            num, den = m.split("/")
            t = t.replace(m, num_to_hanzi(den) + "分之" + num_to_hanzi(num), 1)
        for m in _RE_PERCENT.findall(t):
            t = t.replace(m[0], "百分之" + num_to_hanzi(m[0].rstrip("%")), 1)
        for m in _RE_QUANTIFIED.findall(t):
            t = t.replace(m[0], num_to_hanzi(m[0]), 1)
        for m in _RE_DIGIT_RUN.findall(t):
            t = t.replace(m, num_to_hanzi(m, use_units=False, alt_two=False), 1)
        for m in _RE_NUMBER.findall(t):
            t = t.replace(m[0], num_to_hanzi(m[0]), 1)
        # O2O/B2C: the cardinal pass turned their '2' into '二'; restore
        for m in _RE_LETTER_TWO.findall(t):
            t = t.replace(m[0], m[1] + "2" + m[2], 1)

        # remove exactly the one sentinel added at each end — lstrip/
        # rstrip would also eat genuine leading '^' / trailing '$'
        # characters from the user's text
        if t.startswith("^"):
            t = t[1:]
        if t.endswith("$"):
            t = t[:-1]
        if remove_punc:
            punc = _CN_PUNC + string.punctuation
            t = t.translate(str.maketrans(punc, " " * len(punc)))
        return t


def normalize_chinese(text: str) -> str:
    return NSWNormalizer(text).normalize()
