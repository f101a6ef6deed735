"""Synthetic long-context task generators (RULER-equivalent): the port's
own copy of `magicpig_tpu/evals/ruler/tasks.py`, which imports no JAX;
held sample for sample to it by tests/test_torch_ruler.py.

Re-implements the behavior of the reference's vendored generators
(`evaluations/RULER/data/synthetic/{niah,variable_tracking,
common_words_extraction,freq_words_extraction,qa}.py`) without any external
data assets: haystack text, needles, word lists, and QA documents are all
generated from seeded RNGs, so the suite runs fully offline and
reproducibly. The 13-task suite mirrors `synthetic.yaml` +
`config_tasks.sh:32-46`.

Each generator returns a list of samples:
    {"index", "input", "outputs" (list of reference answers),
     "length" (approx tokens), "answer_prefix"}
The prompt convention matches the reference templates' structure
(`data/synthetic/constants.py:25-56`): context + question, with an
answer-prefix appended by the prediction driver.
"""

from __future__ import annotations

import dataclasses
import random
import string
import uuid

# ---------------------------------------------------------------------------
# Filler text and word stock (offline replacements for RULER's essay corpus
# and nltk word list).
# ---------------------------------------------------------------------------

_SENTENCE_STOCK = [
    "The sun rises over the quiet valley and the fields turn gold.",
    "A river winds through the hills, carrying leaves toward the sea.",
    "Markets open early while vendors arrange fruit in careful rows.",
    "Old libraries keep their silence behind tall wooden doors.",
    "Engineers sketch bridges that may never leave the page.",
    "The train crosses the plain under a wide and cloudless sky.",
    "Gardens grow slowly, indifferent to the calendars of people.",
    "A lighthouse blinks at ships that pass beyond the shoals.",
    "Travelers trade stories in the shade of the station wall.",
    "Clockmakers measure patience in the turning of small gears.",
    "Snow settles on the pass and the road waits for spring.",
    "Fishermen mend their nets while gulls argue over scraps.",
    "The observatory dome opens to a slow parade of stars.",
    "Bakers pull bread from ovens before the town wakes up.",
    "Cartographers argue about coastlines that keep changing.",
    "A violinist practices scales behind a half-open window.",
    "Harvest wagons roll past fences weathered to silver.",
    "The archive smells of paper, dust, and forgotten decisions.",
    "Sailors read the wind in the ripples long before the storm.",
    "Lanterns line the harbor as the evening ferry departs.",
]

_CONSONANTS = "bcdfghjklmnpqrstvwz"
_VOWELS = "aeiou"


def _synthetic_word(rng: random.Random, syllables: int = 3) -> str:
    return "".join(rng.choice(_CONSONANTS) + rng.choice(_VOWELS)
                   for _ in range(syllables))


def _word_stock(rng: random.Random, n: int) -> list[str]:
    seen: set[str] = set()
    while len(seen) < n:
        seen.add(_synthetic_word(rng, rng.choice([2, 3, 4])))
    return sorted(seen)


def _essay_text(rng: random.Random, approx_words: int) -> list[str]:
    """Essay-style filler sentences totalling ~approx_words words."""
    out, words = [], 0
    while words < approx_words:
        s = rng.choice(_SENTENCE_STOCK)
        out.append(s)
        words += len(s.split())
    return out


def approx_tokens(text: str) -> int:
    """Cheap token estimate (~1.35 tokens/word for Llama-style BPE; the
    generator calibrates against a real tokenizer when one is supplied)."""
    return int(len(text.split()) * 1.35) + 1


# ---------------------------------------------------------------------------
# NIAH (needle in a haystack) family — reference data/synthetic/niah.py
# ---------------------------------------------------------------------------


def _needle_value(rng: random.Random, kind: str) -> str:
    if kind == "numbers":
        return str(rng.randint(10**6, 10**7 - 1))
    if kind == "uuids":
        return str(uuid.UUID(int=rng.getrandbits(128)))
    return _synthetic_word(rng)


def gen_niah(num_samples: int, target_tokens: int, seed: int = 42,
             type_haystack: str = "essay", type_needle_k: str = "words",
             type_needle_v: str = "numbers", num_needle_k: int = 1,
             num_needle_v: int = 1, num_needle_q: int = 1,
             tokenizer=None) -> list[dict]:
    """Needle-in-a-haystack with multi-key / multi-value / multi-query
    variants (reference `niah.py`; task grid from `synthetic.yaml`)."""
    samples = []
    for idx in range(num_samples):
        rng = random.Random(f"{seed}:{idx}:niah")
        unit = ("number" if type_needle_v == "numbers"
                else "uuid" if type_needle_v == "uuids" else "word")
        keys = [(_needle_value(rng, "uuids") if type_needle_k == "uuids"
                 else "-".join(_word_stock(rng, 2)) + f"-{idx}-{i}")
                for i in range(max(num_needle_k, num_needle_q))]
        values = {k: [_needle_value(rng, type_needle_v)
                      for _ in range(num_needle_v)] for k in keys}
        needles = [
            f"One of the special magic {unit}s for {k} is: {v}."
            for k in keys for v in values[k]
        ]

        if type_haystack == "repeat":
            base = ("The grass is green. The sky is blue. "
                    "The sun is yellow. Here we go. There and back again.")
            hay = [base] * 10**6
        elif type_haystack == "needle":
            hay = []
            for _ in range(10**6):
                k = "-".join(_word_stock(random.Random(rng.random()), 2))
                hay.append(
                    f"One of the special magic {unit}s for {k} is: "
                    f"{_needle_value(rng, type_needle_v)}.")
                if len(hay) > 64000:
                    break
        else:
            hay = _essay_text(rng, target_tokens)

        # Pack haystack up to the token budget, then splice needles evenly.
        budget = target_tokens - 220  # template + question headroom
        lines, used = [], 0
        for s in hay:
            t = approx_tokens(s)
            if used + t > budget:
                break
            lines.append(s)
            used += t
        if not lines:
            lines = hay[:1]
        pos = sorted(rng.sample(range(len(lines) + 1), min(len(needles),
                                                           len(lines) + 1)))
        for p, n in zip(reversed(pos), reversed(needles)):
            lines.insert(p, n)
        context = " ".join(lines)

        queries = keys[:num_needle_q]
        answers = [v for k in queries for v in values[k]]
        qstr = ", ".join(queries)
        prompt = (
            f"Some special magic {unit}s are hidden within the following "
            f"text. Make sure to memorize them. I will quiz you about the "
            f"{unit}s afterwards.\n{context}\nWhat are all the special magic "
            f"{unit}s for {qstr} mentioned in the provided text?"
        )
        samples.append({
            "index": idx,
            "input": prompt,
            "outputs": answers,
            "length": approx_tokens(prompt),
            "answer_prefix": (f" The special magic {unit}s for {qstr} "
                              f"mentioned in the provided text are"),
        })
    return samples


# ---------------------------------------------------------------------------
# Variable tracking — reference variable_tracking.py
# ---------------------------------------------------------------------------


def gen_variable_tracking(num_samples: int, target_tokens: int,
                          seed: int = 42, num_chains: int = 1,
                          num_hops: int = 4, tokenizer=None) -> list[dict]:
    samples = []
    for idx in range(num_samples):
        rng = random.Random(f"{seed}:{idx}:vt")
        assignments, answers_by_chain = [], []
        for c in range(num_chains):
            names = []
            while len(names) < num_hops + 1:
                nm = "VAR " + "".join(rng.choices(string.ascii_uppercase, k=5))
                if nm not in names:
                    names.append(nm)
            value = str(rng.randint(10**4, 10**5 - 1))
            chain = [f"{names[0]} = {value}"]
            for h in range(num_hops):
                chain.append(f"{names[h + 1]} = {names[h]}")
            assignments.extend(chain)
            answers_by_chain.append(([n.split()[1] for n in names], value))

        filler = _essay_text(rng, target_tokens)
        budget = target_tokens - 200
        lines, used = [], 0
        for s in filler:
            t = approx_tokens(s)
            if used + t > budget:
                break
            lines.append(s)
            used += t
        pos = sorted(rng.sample(range(len(lines) + 1),
                                min(len(assignments), len(lines) + 1)))
        for p, a in zip(reversed(pos), reversed(assignments)):
            lines.insert(p, "[" + a + "]")
        context = " ".join(lines)

        # Query the first chain's value; answers = all its variable names.
        names, value = answers_by_chain[0]
        prompt = (
            "Memorize and track the chain(s) of variable assignment hidden "
            f"in the following text.\n\n{context}\nQuestion: Find all "
            f"variables that are assigned the value {value} in the text "
            "above."
        )
        samples.append({
            "index": idx,
            "input": prompt,
            "outputs": names,
            "length": approx_tokens(prompt),
            "answer_prefix": (
                f" Answer: According to the chain(s) of variable assignment "
                f"in the text above, {len(names)} variables are assigned the "
                f"value {value}, they are: "),
        })
    return samples


# ---------------------------------------------------------------------------
# Common / frequent words extraction — reference
# common_words_extraction.py, freq_words_extraction.py
# ---------------------------------------------------------------------------


def gen_common_words(num_samples: int, target_tokens: int, seed: int = 42,
                     freq_cw: int = 30, freq_ucw: int = 3, num_cw: int = 10,
                     tokenizer=None) -> list[dict]:
    samples = []
    for idx in range(num_samples):
        rng = random.Random(f"{seed}:{idx}:cwe")
        # Scale the uncommon-word count to fill the context budget.
        per_entry_tokens = 4.0
        total_entries = max(int((target_tokens - 150) / per_entry_tokens), 60)
        n_ucw = max((total_entries - num_cw * freq_cw) // freq_ucw, 10)
        stock = _word_stock(rng, num_cw + n_ucw)
        rng.shuffle(stock)
        common, uncommon = stock[:num_cw], stock[num_cw:]
        entries = common * freq_cw + uncommon * freq_ucw
        rng.shuffle(entries)
        listing = " ".join(f"{i + 1}. {w}" for i, w in enumerate(entries))
        prompt = (
            "Below is a numbered list of words. In these words, some appear "
            "more often than others. Memorize the ones that appear most "
            f"often.\n{listing}\nQuestion: What are the 10 most common words "
            "in the above list?"
        )
        samples.append({
            "index": idx,
            "input": prompt,
            "outputs": common,
            "length": approx_tokens(prompt),
            "answer_prefix": (" Answer: The top 10 words that appear most "
                              "often in the list are:"),
        })
    return samples


def gen_freq_words(num_samples: int, target_tokens: int, seed: int = 42,
                   alpha: float = 2.0, tokenizer=None) -> list[dict]:
    """Zipf-distributed coded words; find the top 3 (reference
    `freq_words_extraction.py`, alpha from `synthetic.yaml`)."""
    samples = []
    for idx in range(num_samples):
        rng = random.Random(f"{seed}:{idx}:fwe")
        vocab = _word_stock(rng, 140)
        rng.shuffle(vocab)
        # Zipf ranks: P(rank r) ∝ 1 / r^alpha, rank 1..len(vocab).
        weights = [1.0 / ((r + 1) ** alpha) for r in range(len(vocab))]
        n_words = max(int((target_tokens - 120) / 1.8), 50)
        coded = rng.choices(vocab, weights=weights, k=n_words)
        # Guarantee the top-3 are unambiguous in the realized sample.
        counts: dict[str, int] = {}
        for w in coded:
            counts[w] = counts.get(w, 0) + 1
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:3]
        text = " ".join(w + " ...." for w in coded)
        prompt = (
            "Read the following coded text and track the frequency of each "
            f"coded word. Find the three most frequently appeared coded "
            f"words. {text}\nQuestion: Do not provide any explanation. "
            "Please ignore the dots '....'. What are the three most "
            "frequently appeared words in the above coded text?"
        )
        samples.append({
            "index": idx,
            "input": prompt,
            "outputs": [w for w, _ in top],
            "length": approx_tokens(prompt),
            "answer_prefix": (" Answer: According to the coded text above, "
                              "the three most frequently appeared words "
                              "are:"),
        })
    return samples


# ---------------------------------------------------------------------------
# QA — reference qa.py (squad/hotpotqa). Offline synthetic facts corpus.
# ---------------------------------------------------------------------------


def gen_qa(num_samples: int, target_tokens: int, seed: int = 42,
           dataset: str = "synthetic", tokenizer=None) -> list[dict]:
    """Multi-document QA. The reference draws documents from SQuAD (qa_1)
    and HotpotQA (qa_2) (`qa.py`); offline we synthesize fact documents.
    dataset="synthetic" (qa_1): single-hop — one document holds the queried
    fact, the rest are distractors. dataset="synthetic2" (qa_2): TWO-hop
    like HotpotQA — the answer requires chaining facts from two different
    documents ("who leads the city where person P was born?"), so partial
    retrieval of only one supporting document cannot answer."""
    samples = []
    roles = ["founder", "mayor", "curator", "architect", "captain",
             "librarian", "composer", "chancellor"]
    two_hop = dataset == "synthetic2"
    for idx in range(num_samples):
        rng = random.Random(f"{seed}:{idx}:qa:{dataset}")

        def mkdoc(r):
            city = _synthetic_word(r, 3).capitalize()
            person = (_synthetic_word(r, 2) + " " + _synthetic_word(r, 3)).title()
            role = r.choice(roles)
            year = r.randint(1700, 2020)
            body = " ".join(_essay_text(r, 80))
            return (f"Document: The {role} of {city} since {year} is "
                    f"{person}. {body}"), (role, city, person)

        def mkbridge(r, person_b, city_b):
            """Bridge document: ties a person to a birth city."""
            year = r.randint(1900, 2000)
            body = " ".join(_essay_text(r, 80))
            return (f"Document: {person_b} was born in {city_b} in {year}. "
                    f"{body}")

        docs, facts = [], []
        budget = target_tokens - 200
        used = 0
        while True:
            doc, fact = mkdoc(rng)
            t = approx_tokens(doc)
            if used + t > budget and docs:
                break
            docs.append(doc)
            facts.append(fact)
            used += t
            if used > budget:
                break
        q_idx = rng.randrange(len(docs))
        role, city, person = facts[q_idx]
        if two_hop:
            # A bridge person born in `city`; the question chains through
            # them to the role-holder of that city.
            bridge = (_synthetic_word(rng, 2) + " "
                      + _synthetic_word(rng, 3)).title()
            bdoc = mkbridge(rng, bridge, city)
            docs.insert(rng.randrange(len(docs) + 1), bdoc)
            question = (f"Who is the {role} of the city where {bridge} "
                        f"was born?")
        else:
            question = f"Who is the {role} of {city}?"
        context = "\n\n".join(docs)
        prompt = (
            "Answer the question based on the given documents. Only give me "
            "the answer and do not output any other words.\n\nThe following "
            f"are given documents.\n\n{context}\n\nAnswer the question based "
            "on the given documents. Only give me the answer and do not "
            f"output any other words.\n\nQuestion: {question}"
        )
        samples.append({
            "index": idx,
            "input": prompt,
            "outputs": [person],
            "length": approx_tokens(prompt),
            "answer_prefix": " Answer:",
        })
    return samples


# ---------------------------------------------------------------------------
# Task suite (the reference's 13 tasks, synthetic.yaml / config_tasks.sh)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    fn: object
    args: dict
    metric: str              # "string_match_all" | "string_match_part"
    tokens_to_generate: int


TASK_SUITE: dict[str, TaskSpec] = {
    "niah_single_1": TaskSpec("niah_single_1", gen_niah,
                              dict(type_haystack="repeat"),
                              "string_match_all", 128),
    "niah_single_2": TaskSpec("niah_single_2", gen_niah,
                              dict(type_haystack="essay"),
                              "string_match_all", 128),
    "niah_single_3": TaskSpec("niah_single_3", gen_niah,
                              dict(type_haystack="essay",
                                   type_needle_v="uuids"),
                              "string_match_all", 128),
    "niah_multikey_1": TaskSpec("niah_multikey_1", gen_niah,
                                dict(type_haystack="essay", num_needle_k=4),
                                "string_match_all", 128),
    "niah_multikey_2": TaskSpec("niah_multikey_2", gen_niah,
                                dict(type_haystack="needle"),
                                "string_match_all", 128),
    "niah_multikey_3": TaskSpec("niah_multikey_3", gen_niah,
                                dict(type_haystack="needle",
                                     type_needle_k="uuids",
                                     type_needle_v="uuids"),
                                "string_match_all", 128),
    "niah_multivalue": TaskSpec("niah_multivalue", gen_niah,
                                dict(type_haystack="essay", num_needle_v=4),
                                "string_match_all", 128),
    "niah_multiquery": TaskSpec("niah_multiquery", gen_niah,
                                dict(type_haystack="essay", num_needle_q=4,
                                     num_needle_k=4),
                                "string_match_all", 128),
    "vt": TaskSpec("vt", gen_variable_tracking,
                   dict(num_chains=1, num_hops=4), "string_match_all", 30),
    "cwe": TaskSpec("cwe", gen_common_words,
                    dict(freq_cw=30, freq_ucw=3, num_cw=10),
                    "string_match_all", 120),
    "fwe": TaskSpec("fwe", gen_freq_words, dict(alpha=2.0),
                    "string_match_all", 50),
    "qa_1": TaskSpec("qa_1", gen_qa, dict(dataset="synthetic"),
                     "string_match_part", 32),
    "qa_2": TaskSpec("qa_2", gen_qa, dict(dataset="synthetic2"),
                     "string_match_part", 32),
}

SEQ_LENGTHS = (16384, 32768, 65536, 98304)  # config_models.sh:18-23


def generate_task(name: str, num_samples: int, target_tokens: int,
                  seed: int = 42, tokenizer=None) -> list[dict]:
    spec = TASK_SUITE[name]
    return spec.fn(num_samples, target_tokens, seed=seed, tokenizer=tokenizer,
                   **spec.args)
