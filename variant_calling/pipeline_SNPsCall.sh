#!/bin/bash
# GATK best-practices SNP calling over a (smoothed) FASTQ pair — the
# scientific acceptance test for lossy smoothing: the VCF called from
# bfqzip_tpu's output must agree with the one called from the original
# FASTQ (compare with rtg vcfeval).
#
# Mirrors the reference validation pipeline
# (reference variant_calling/pipeline_SNPsCall.sh:15-50): bwa index+mem ->
# MarkDuplicatesSpark -> HaplotypeCaller -> SelectVariants(SNP) ->
# VariantFiltration.  Runs entirely on the host; tool paths are configurable via
# environment variables.
set -euo pipefail

BWA=${BWA:-bwa}
GATK=${GATK:-gatk}
SAMTOOLS=${SAMTOOLS:-samtools}
REF=${REF:?set REF to the reference FASTA}

fastq_1=$1
fastq_2=$2
data=$(basename "$fastq_1" | cut -d'_' -f 1)

# index the reference once
if [ ! -f "$REF.amb" ]; then
    "$BWA" index "$REF"
fi
if [ ! -f "$REF.fai" ]; then
    "$SAMTOOLS" faidx "$REF"
fi
dict="${REF%.*}.dict"
if [ ! -f "$dict" ]; then
    "$GATK" CreateSequenceDictionary -R "$REF" -O "$dict"
fi

# 1) alignment
"$BWA" mem -Y -R '@RG\tID:sample1\tLB:lib1\tPL:ILLUMINA\tPM:HISEQ\tSM:sample1' \
    "$REF" "$fastq_1" "$fastq_2" > "aligned_${data}.sam"

# 2) mark duplicates + sort
"$GATK" MarkDuplicatesSpark -I "aligned_${data}.sam" \
    -O "sorted_dedup_${data}.bam" -M "dedup_metrics_${data}.txt"

# 3) call variants
"$GATK" HaplotypeCaller -R "$REF" -I "sorted_dedup_${data}.bam" \
    -O "raw_variants_${data}.vcf"

# 4) select SNPs
"$GATK" SelectVariants -R "$REF" -V "raw_variants_${data}.vcf" \
    --select-type-to-include SNP -O "raw_snps_${data}.vcf"

# 5) hard filtering (GATK best-practices thresholds, as in the reference)
"$GATK" VariantFiltration -R "$REF" -V "raw_snps_${data}.vcf" \
    -O "filtered_snps_${data}.vcf" \
    --filter-name "QD_filter"            --filter-expression "QD < 2.0" \
    --filter-name "FS_filter"            --filter-expression "FS > 60.0" \
    --filter-name "MQ_filter"            --filter-expression "MQ < 40.0" \
    --filter-name "SOR_filter"           --filter-expression "SOR > 4.0" \
    --filter-name "MQRankSum_filter"     --filter-expression "MQRankSum < -12.5" \
    --filter-name "ReadPosRankSum_filter" --filter-expression "ReadPosRankSum < -8.0"

echo "wrote filtered_snps_${data}.vcf"
